// Fused bucket-aligned HULL contact table (Hopper, sm_90a).
//
// Replaces the TPU kernel bucket_hull_contact_table
// (physics_tpu/ops/hull_table.py:1092, call :1218, body _make_hull_kernel
// :373-1084). Plain version: bucket_hull_contact_table_plain in
// physics_tpu_torch/ops/hull_table.py; the device code below computes the
// same operations in the same order (built with -fmad=false), so the two
// agree bit for bit.
//
// Seven launches on the caller's stream:
//   1. prefilter (one block per bucket of 128 ranks): the OBB face-axis test
//      over the bucket's `cap` candidate lanes; survivors compacted, order
//      preserved, into `cap2` lanes with the stable block scan (common.cuh);
//   2. SAT separations, a tiled product with fused reductions: block
//      (lane tile, bucket, split) stages one split of the lanes' ordered type
//      pair coefficient rows in shared memory (8 faces by vertex, or 3 edge
//      axes: the 3 axis rows, then A's and B's vertex rows by direction),
//      and each of its 128 threads dots them with its lane's
//      m_ext = [R_aᵀR_b | dpa | dpb | 1]: the min over a face's vertex rows,
//      for an edge axis the separation from the min and max over A's and B's
//      vertex rows with its length guard, and the best face or axis of the
//      split (first index on ties) goes to a per-split scratch record;
//   3. manifold (8 threads per lane): the splits' bests combined in order,
//      the axis choice, the incident face (faces over the 8 threads), the
//      reference-face clip (each thread, redundantly), the edge-edge
//      closest point (vertex supports and edges over the 8 threads) and
//      the kk deepest slots, written to a per-emission scratch record;
//      given a counter pair (tracing on), it also adds each SAT lane and
//      each lane whose SAT found overlap;
//   4. ground (one warp per rank): the kg lowest hull vertices below the
//      plane, vertices over the warp;
//   5. scan (one block per bucket): the stable block scan over the bucket's
//      emissions in the reference's order (pick-major over the lanes, then
//      pick-major over the ranks) into ccap slots, and the meta counters;
//   6. rows (one thread per emission): the table rows with body-frame
//      anchors and each slot's warm key; the slots beyond the bucket's count
//      zeroed;
//   7. warm (common.cuh warm_match_kernel, shared with the box table; a
//      warp per 8 slots): each slot's first previous slot of the bucket with
//      the same key, ballots over 4 × 32 previous slots at a time, up to the
//      last previous slot that can match.
// What bounds it on the H100: the SAT's ~5,700 16-term dots a lane, about
// 0.7 G f32 operations at the 1,024-hull rain; shared among the lanes of a
// type pair, the coefficient rows are read from shared memory as warp-wide
// broadcasts while 4 warps of each of ~1,100 blocks keep the FP pipes busy.
// The sums stay left to right with no FMA, so each value equals the plain
// version's; min and max are exact in any order, and each split's best is
// combined in index order with the serial rule, so the split keeps the bits;
// the warp-wide argmaxes take the lowest index among equal values, which is
// the serial loops' first-index rule.
// The TPU kernel's H² masked passes become one pass per ordered type pair
// present in a block; its one-hot selection matmuls become indexed reads.

#include <climits>
#include <cstdint>

#include "common.cuh"

namespace {

struct hull_table_warm;  // names 2.4's instance of the shared warm match

constexpr int kBlock = 128;        // ranks per bucket
// The manifold kernel holds a face polygon's E vertices and its 2E clip
// slots in registers, so it is built for a few capacities of E (the
// library's largest face, at run time d.e) and launched with the smallest
// that holds it; slot ids and keys follow the run-time E. Above
// kRegFaceVerts the polygons, the clip and the slot scores live in local
// memory (the thread's stack, cached in L1) and the clip is a serial loop
// over the live slots (clip_serial), with the same operations in the same
// order, up to the reference's limit 2E + 1 ≤ 128.
constexpr int kRegFaceVerts = 16;  // the largest capacity held in registers
constexpr int kMaxFaceVerts = 64;  // the largest capacity built
constexpr int kThreads = 256;      // prefilter
constexpr int kSatThreads = 128;   // SAT lanes a block
constexpr int kFacesPerSplit = 8;
constexpr int kAxesPerSplit = 3;
constexpr int kWarps = 4;          // ground blocks: a warp per rank
constexpr int kGroup = 8;          // manifold: threads a lane
constexpr int kManThreads = 128;   // manifold blocks: 16 lanes
constexpr int kScanThreads = 1024;
constexpr int kRowThreads = 128;
constexpr float kBig = 1e30f;
constexpr int kGeomRow0 = 24;      // narrow-phase block of the unified table

struct Dims {
  int nb, cap, cap2, sat_cap, ccap, kk, kg, npad, rows, h;
  int e;        // vertices of the library's largest face (clip slots 2e, slots 2e + 1)
  int bucket0;  // the range's first bucket: bucket b of a launch starts at rank (bucket0 + b)·128
  int fp, vcap, d2, d2p, e2p;
  int r16, r32, rcb;   // rows of c16 / c32 / cb per type pair
  int ns_face, ns_edge;  // SAT splits over the 2·fp faces and the d2 edge axes
  float gh;
};

// Scratch carved from one int32 buffer, in 4-byte words.
struct Scratch {
  int* lanes;     // [2, nb, sat_cap] surviving lanes (A, B window-local ranks)
  int* dropped2;  // [nb] prefilter survivors beyond cap2
  float* part_v;  // [ns, nb, sat_cap] best separation of each SAT split
  int* part_i;    // [ns, nb, sat_cap] its face / axis index
  float* em_f;    // [8, n_em] pair emissions: point xyz, normal xyz, depth, slot id
  int* em_i;      // [n_em] activity
  float* gnd_f;   // [8, n_g] ground emissions: point xyz, local vertex xyz, depth, vertex id
  int* gnd_i;     // [n_g] activity
  int* slot;      // [nb, e_tot] table slot of each emission (−1 inactive)
  int* nact;      // [nb] active emissions
  float* keys;    // [2, nb·ccap] warm key (ck, KH) of each slot
  float2* prev;   // [nb·ccap] previous keys (ck, KH), compact_prev_keys
  int* n_prev;    // [nb] previous slots the warm match scans
  size_t words;
};

__host__ __device__ inline size_t round4(size_t x) { return (x + 3) / 4 * 4; }

__host__ __device__ inline Scratch carve_scratch(int* base, const Dims& d) {
  const size_t ns = (size_t)d.ns_face + d.ns_edge;
  const size_t lanes = (size_t)d.nb * d.sat_cap;
  const size_t n_em = (size_t)d.nb * d.kk * d.sat_cap;
  const size_t n_g = (size_t)d.nb * d.kg * kBlock;
  const size_t e_tot = (size_t)d.kk * d.sat_cap + (size_t)d.kg * kBlock;
  const size_t sizes[13] = {2 * lanes, (size_t)d.nb, ns * lanes, ns * lanes, 8 * n_em, n_em,
                            8 * n_g, n_g, (size_t)d.nb * e_tot, (size_t)d.nb, 2 * (size_t)d.nb * d.ccap,
                            2 * (size_t)d.nb * d.ccap, (size_t)d.nb};
  int* p[13];
  size_t off = 0;
  for (int k = 0; k < 13; ++k) {
    p[k] = base ? base + off : nullptr;
    off += round4(sizes[k]);
  }
  Scratch s;
  s.lanes = p[0];
  s.dropped2 = p[1];
  s.part_v = reinterpret_cast<float*>(p[2]);
  s.part_i = p[3];
  s.em_f = reinterpret_cast<float*>(p[4]);
  s.em_i = p[5];
  s.gnd_f = reinterpret_cast<float*>(p[6]);
  s.gnd_i = p[7];
  s.slot = p[8];
  s.nact = p[9];
  s.keys = reinterpret_cast<float*>(p[10]);
  s.prev = reinterpret_cast<float2*>(p[11]);
  s.n_prev = p[12];
  s.words = off;
  return s;
}

struct Hull {
  V3 p;
  float r[9];   // world rotation, row-major
  V3 h;         // local-AABB half extents
  float fric, rest, movable, id, typ;
  V3 c;         // world OBB centre
};

__device__ __forceinline__ Hull load_hull(const float* geom, int npad, int col) {
  const float* g = geom + (size_t)kGeomRow0 * npad + col;
  Hull b;
  b.p = mk(g[0], g[(size_t)npad], g[2 * (size_t)npad]);
#pragma unroll
  for (int k = 0; k < 9; ++k) b.r[k] = g[(size_t)(3 + k) * npad];
  b.h = mk(g[12 * (size_t)npad], g[13 * (size_t)npad], g[14 * (size_t)npad]);
  b.fric = g[15 * (size_t)npad];
  b.rest = g[16 * (size_t)npad];
  b.movable = g[17 * (size_t)npad];
  b.id = g[18 * (size_t)npad];
  b.typ = g[19 * (size_t)npad];
  b.c = mk(g[20 * (size_t)npad], g[21 * (size_t)npad], g[22 * (size_t)npad]);
  return b;
}

__device__ __forceinline__ Hull zero_hull() {
  Hull b;
  b.p = mk(0.f, 0.f, 0.f);
#pragma unroll
  for (int k = 0; k < 9; ++k) b.r[k] = 0.f;
  b.h = b.p;
  b.c = b.p;
  b.fric = b.rest = b.movable = b.id = b.typ = 0.f;
  return b;
}

// A coefficient row (4 float4) dotted with m_ext, summed left to right (_lin16).
__device__ __forceinline__ float sum16(const float4 a, const float4 b, const float4 c, const float4 d,
                                       const float (&m)[16]) {
  float s = a.x * m[0];
  s = s + a.y * m[1];
  s = s + a.z * m[2];
  s = s + a.w * m[3];
  s = s + b.x * m[4];
  s = s + b.y * m[5];
  s = s + b.z * m[6];
  s = s + b.w * m[7];
  s = s + c.x * m[8];
  s = s + c.y * m[9];
  s = s + c.z * m[10];
  s = s + c.w * m[11];
  s = s + d.x * m[12];
  s = s + d.y * m[13];
  s = s + d.z * m[14];
  s = s + d.w * m[15];
  return s;
}

// ... of a row in device memory
__device__ __forceinline__ float dot16(const float* __restrict__ row, const float (&m)[16]) {
  const float4* r4 = reinterpret_cast<const float4*>(row);
  return sum16(__ldg(r4), __ldg(r4 + 1), __ldg(r4 + 2), __ldg(r4 + 3), m);
}

// ... of a row staged in shared memory (every thread of a warp reads the
// same row: a broadcast)
__device__ __forceinline__ float dot16s(const float4* r, const float (&m)[16]) {
  return sum16(r[0], r[1], r[2], r[3], m);
}

// 9 coefficients at stride `stride` dotted with M, left to right (_lin9).
__device__ __forceinline__ float dot9(const float* __restrict__ c, size_t stride, const float (&m9)[9]) {
  float s = __ldg(c) * m9[0];
#pragma unroll
  for (int k = 1; k < 9; ++k) s = s + __ldg(c + k * stride) * m9[k];
  return s;
}

// (best, index) over an aligned group of G threads of a warp (`mask` its
// bits): the largest value, the lowest index among equals, on every thread
// of the group. With each thread's own items taken in index order by the
// serial rule (first wins), this is the serial loop's answer.
template <int G>
__device__ __forceinline__ void group_argmax(float& v, int& i, unsigned mask) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(mask, v, off);
    const int oi = __shfl_xor_sync(mask, i, off);
    if (ov > v || (ov == v && oi < i)) {
      v = ov;
      i = oi;
    }
  }
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) { group_argmax<32>(v, i, 0xffffffffu); }

// The two hulls of SAT lane `lane` of bucket b; returns the lane's ordered
// type pair, or −1 when the SAT skips it (empty, no movable hull, a
// non-hull, or a type beyond the library).
__device__ __forceinline__ int lane_pair(const float* geom, const int* lanes, const Dims& d, int b, int lane,
                                         Hull& ga, Hull& gb) {
  const int start = (d.bucket0 + b) * kBlock;
  const int la = lanes[(size_t)b * d.sat_cap + lane];
  const int lb = lanes[((size_t)d.nb + b) * d.sat_cap + lane];
  if (la < 0) return -1;
  ga = load_hull(geom, d.npad, start + la);
  gb = lb >= 0 ? load_hull(geom, d.npad, start + lb) : zero_hull();
  const bool valid = ((ga.movable > 0.f) || (gb.movable > 0.f)) && (ga.typ > 0.f) && (gb.typ > 0.f);
  const int ta = (int)(ga.typ - 1.f), tb = (int)(gb.typ - 1.f);
  if (!valid || ta >= d.h || tb >= d.h) return -1;
  return ta * d.h + tb;
}

// m_ext = [M = RaᵀRb | dpa | dpb | 1]
__device__ __forceinline__ void make_mext(const Hull& ga, const Hull& gb, float (&mext)[16], float (&dpa)[3]) {
  const float* ra = ga.r;
  const float* rb = gb.r;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) mext[3 * i + j] = ra[i] * rb[j] + ra[3 + i] * rb[3 + j] + ra[6 + i] * rb[6 + j];
  const V3 dp = sub(gb.p, ga.p);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    dpa[i] = ra[i] * dp.x + ra[3 + i] * dp.y + ra[6 + i] * dp.z;
    mext[9 + i] = dpa[i];
    mext[12 + i] = -(rb[i] * dp.x + rb[3 + i] * dp.y + rb[6 + i] * dp.z);
  }
  mext[15] = 1.f;
}

// ---------------------------------------------------------------------------
// 1. prefilter + order-preserving compaction to cap2 lanes
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
hull_prefilter_kernel(const float* __restrict__ geom, const int* __restrict__ la_in, const int* __restrict__ lb_in,
                      int* __restrict__ lanes, int* __restrict__ dropped2, Dims d) {
  __shared__ int warp_sums[32];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int start = (d.bucket0 + b) * kBlock;
  int* la2 = lanes + (size_t)b * d.sat_cap;
  int* lb2 = lanes + ((size_t)d.nb + b) * d.sat_cap;
  if (!d.cap2) {
    for (int i = tid; i < d.sat_cap; i += blockDim.x) {
      la2[i] = la_in[(size_t)b * d.cap + i];
      lb2[i] = lb_in[(size_t)b * d.cap + i];
    }
    if (tid == 0) dropped2[b] = 0;
    return;
  }
  for (int i = tid; i < d.sat_cap; i += blockDim.x) la2[i] = lb2[i] = -1;
  __syncthreads();
  int offset = 0;
  for (int c0 = 0; c0 < d.cap; c0 += blockDim.x) {
    const int c = c0 + tid;
    int la = -1, lb = -1, keep = 0;
    if (c < d.cap) {
      la = la_in[(size_t)b * d.cap + c];
      lb = lb_in[(size_t)b * d.cap + c];
      if (la >= 0) {
        const Hull ga = load_hull(geom, d.npad, start + la);
        const Hull gb = lb >= 0 ? load_hull(geom, d.npad, start + lb) : zero_hull();
        const float sep = face_sat_sep(sub(gb.c, ga.c), ga.r, gb.r, ga.h, gb.h);
        keep = (sep < 0.f) && ((ga.movable > 0.f) || (gb.movable > 0.f)) && (ga.typ > 0.f) && (gb.typ > 0.f);
      }
    }
    int total;
    const int pos = offset + block_exclusive_scan(keep, warp_sums, total);
    if (keep && pos < d.cap2) {
      la2[pos] = la;
      lb2[pos] = lb;
    }
    offset += total;
  }
  if (tid == 0) dropped2[b] = offset > d.cap2 ? offset - d.cap2 : 0;
}

// ---------------------------------------------------------------------------
// 2. SAT separations: coefficient rows × lanes' m_ext, reduced per split
// ---------------------------------------------------------------------------

// Rows of one split staged in shared memory: the larger of a face split and
// an edge split.
__host__ __device__ inline int sat_split_rows(int vcap) {
  const int face_rows = kFacesPerSplit * vcap;
  const int edge_rows = kAxesPerSplit * (3 + 2 * vcap);
  return face_rows > edge_rows ? face_rows : edge_rows;
}

__global__ void __launch_bounds__(kSatThreads)
hull_sat_kernel(const float* __restrict__ geom, const float* __restrict__ c16_all, Scratch sc, Dims d) {
  extern __shared__ __align__(16) char smem_raw[];
  float4* rows = reinterpret_cast<float4*>(smem_raw);
  __shared__ int present;   // bit p: a lane of ordered type pair p
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = blockIdx.x * kSatThreads + tid;
  if (tid == 0) present = 0;
  __syncthreads();
  float mext[16], dpa[3];
  int p = -1;
  if (lane < d.sat_cap) {
    Hull ga, gb;
    p = lane_pair(geom, sc.lanes, d, b, lane, ga, gb);
    if (p >= 0) {
      make_mext(ga, gb, mext, dpa);
      atomicOr(&present, 1 << p);
    }
  }
  __syncthreads();
  const int mask = present;
  const int vcap = d.vcap, fp = d.fp, d2p = d.d2p;
  const bool faces = split < d.ns_face;
  const int first = faces ? split * kFacesPerSplit : (split - d.ns_face) * kAxesPerSplit;
  const int count = faces ? min(kFacesPerSplit, 2 * fp - first) : min(kAxesPerSplit, d.d2 - first);
  const int per = faces ? vcap : 3 + 2 * vcap;   // rows of one face / axis
  const int lax = 2 * vcap * fp, eav = lax + 3 * d2p, ebv = eav + vcap * d2p;
  float best = 0.f;
  int best_idx = -1;
  for (int q = 0; q < d.h * d.h; ++q) {
    if (!((mask >> q) & 1)) continue;   // uniform over the block
    const float4* c16 = reinterpret_cast<const float4*>(c16_all + (size_t)q * d.r16 * 16);
    __syncthreads();   // the previous pair's rows are read
    for (int i = tid; i < count * per * 4; i += kSatThreads) {
      const int r = i >> 2;
      const int k = r / per, j = r - k * per;
      const int it = first + k;
      int row;
      if (faces) {
        const int side = it >= fp ? 1 : 0;
        row = side * vcap * fp + j * fp + (it - side * fp);
      } else if (j < 3) {
        row = lax + j * d2p + it;
      } else if (j < 3 + vcap) {
        row = eav + (j - 3) * d2p + it;
      } else {
        row = ebv + (j - 3 - vcap) * d2p + it;
      }
      rows[i] = __ldg(c16 + (size_t)row * 4 + (i & 3));
    }
    __syncthreads();
    if (p != q) continue;
    if (faces) {
      // a face's separation: min over the other hull's vertices
      // two faces an iteration: independent sum chains
      for (int k = 0; k < count; k += 2) {
        const bool two = k + 1 < count;
        const float4* f0 = rows + (size_t)k * per * 4;
        const float4* f1 = two ? f0 + (size_t)per * 4 : f0;
        float s0 = dot16s(f0, mext), s1 = dot16s(f1, mext);
#pragma unroll 4
        for (int v = 1; v < vcap; ++v) {
          s0 = fminf(s0, dot16s(f0 + v * 4, mext));
          s1 = fminf(s1, dot16s(f1 + v * 4, mext));
        }
        if (best_idx < 0 || s0 > best) {
          best = s0;
          best_idx = first + k;
        }
        if (two && s1 > best) {
          best = s1;
          best_idx = first + k + 1;
        }
      }
    } else {
      for (int k = 0; k < count; ++k) {
        const float4* ar = rows + (size_t)k * per * 4;
        const float ax0 = dot16s(ar, mext);
        const float ax1 = dot16s(ar + 4, mext);
        const float ax2 = dot16s(ar + 8, mext);
        const float alen = sqrtf(fmaxf(ax0 * ax0 + ax1 * ax1 + ax2 * ax2, 1e-18f));
        float se = -kBig;
        if (alen > 1e-6f) {
          const float t_ax = -(ax0 * dpa[0] + ax1 * dpa[1] + ax2 * dpa[2]);
          const float4* va = ar + 12;
          const float4* vb = va + (size_t)vcap * 4;
          float min_a = dot16s(va, mext), max_a = min_a;
          float min_b = dot16s(vb, mext), max_b = min_b;
#pragma unroll 4
          for (int v = 1; v < vcap; ++v) {
            const float sa = dot16s(va + v * 4, mext);
            const float sb = dot16s(vb + v * 4, mext);
            min_a = fminf(min_a, sa);
            max_a = fmaxf(max_a, sa);
            min_b = fminf(min_b, sb);
            max_b = fmaxf(max_b, sb);
          }
          const float num = t_ax < 0.f ? min_b - max_a - t_ax : min_a - max_b + t_ax;
          se = num / alen;
        }
        if (best_idx < 0 || se > best) {
          best = se;
          best_idx = first + k;
        }
      }
    }
  }
  if (lane < d.sat_cap) {
    const size_t o = ((size_t)split * d.nb + b) * d.sat_cap + lane;
    sc.part_v[o] = best;
    sc.part_i[o] = best_idx;
  }
}

// ---------------------------------------------------------------------------
// 3. axis choice, clip, edge-edge point and top-k per lane
// ---------------------------------------------------------------------------

// clip (common.cuh) as a loop over the m live slots, for capacities too
// large to unroll: each output slot is 0 + its one input (the one-hot sum
// of the unrolled clip), slots from cap_rt on stay as they are (0).
template <int CAP>
__device__ __noinline__ void clip_serial(float (&pu)[CAP], float (&pv)[CAP], float (&ps)[CAP], int& m, float cu,
                                         float cv, float d, int cap_rt) {
  float ou[CAP], ov[CAP], os[CAP];
#pragma unroll 1
  for (int j = 0; j < cap_rt; ++j) ou[j] = ov[j] = os[j] = 0.f;
  const int mm = m;
  int start = 0;
#pragma unroll 1
  for (int i = 0; i < mm; ++i) {
    const int nx = (i + 1) == mm ? 0 : i + 1;
    const float g = cu * pu[i] + cv * pv[i] - d;
    const float gn = cu * pu[nx] + cv * pv[nx] - d;
    const bool inside = g <= 0.f;
    const bool crossing = (g <= 0.f) != (gn <= 0.f);
    if (inside && start < cap_rt) {
      ou[start] = 0.f + pu[i];
      ov[start] = 0.f + pv[i];
      os[start] = 0.f + ps[i];
    }
    const int at = start + (int)inside;
    if (crossing && at < cap_rt) {
      const float denom = g - gn;
      const float t = fabsf(denom) > 1e-12f ? g / denom : 0.f;
      ou[at] = 0.f + (pu[i] + t * (pu[nx] - pu[i]));
      ov[at] = 0.f + (pv[i] + t * (pv[nx] - pv[i]));
      os[at] = 0.f + (ps[i] + t * (ps[nx] - ps[i]));
    }
    start += (int)inside + (int)crossing;
  }
#pragma unroll 1
  for (int j = 0; j < cap_rt; ++j) {
    pu[j] = ou[j];
    pv[j] = ov[j];
    ps[j] = os[j];
  }
  m = start < cap_rt ? start : cap_rt;
}

// Emission record of the pair phase: em_f rows 0:3 point, 3:6 normal,
// 6 depth, 7 slot id; em_i the activity flag. Index (b·kk + pick)·sat_cap + lane.
__device__ __forceinline__ void write_inactive(int* em_i, size_t e0, int kk, int sat_cap) {
  for (int pick = 0; pick < kk; ++pick) em_i[e0 + (size_t)pick * sat_cap] = 0;
}

template <int E>
__global__ void __launch_bounds__(kManThreads)
hull_manifold_kernel(const float* __restrict__ geom, const float* __restrict__ c16_all,
                     const float* __restrict__ c32_all, const float* __restrict__ c88_all,
                     const float* __restrict__ c80_all, const float* __restrict__ cb_all,
                     const int* __restrict__ eidx_all, unsigned long long* __restrict__ counts, Scratch sc,
                     Dims d) {
  extern __shared__ __align__(16) char smem_raw[];
  // kGroup threads per lane: every thread of the group follows the lane's
  // control flow and computes its scalars (the clip), the split, incident
  // face, support and edge loops are spread over the group and reduced
  // with group_argmax
  const int t = threadIdx.x % kGroup;
  const int grp = threadIdx.x / kGroup;
  const unsigned gmask = ((1u << kGroup) - 1u) << ((threadIdx.x & 31) & ~(kGroup - 1));
  // supports of every vertex of A (then B) on the chosen edge axis
  float* sup = reinterpret_cast<float*>(smem_raw) + (size_t)grp * 2 * d.vcap;
  const int b = blockIdx.y;
  const int lane = blockIdx.x * (kManThreads / kGroup) + grp;
  if (lane >= d.sat_cap) return;
  const size_t n_em = (size_t)d.nb * d.kk * d.sat_cap;
  const size_t e0 = (size_t)b * d.kk * d.sat_cap + lane;
  int* em_i = sc.em_i;
  float* em_f = sc.em_f;
  Hull ga, gb;
  const int p = lane_pair(geom, sc.lanes, d, b, lane, ga, gb);
  if (p < 0) {
    if (t == 0) write_inactive(em_i, e0, d.kk, d.sat_cap);
    return;
  }
  constexpr int kSl = 2 * E;   // clip slots held
  constexpr int kNs = kSl + 1;
  const int fp = d.fp, vcap = d.vcap, d2p = d.d2p, e2p = d.e2p;
  const int ne = d.e, n_sl = 2 * d.e;   // the library's: the edge slot is n_sl
  const float* c16 = c16_all + (size_t)p * d.r16 * 16;
  const float* c32 = c32_all + (size_t)p * d.r32 * fp;
  const float* c88 = c88_all + (size_t)p * 18 * vcap * d2p;
  const float* c80 = c80_all + (size_t)p * 16 * e2p;
  const float* cb = cb_all + (size_t)p * d.rcb;
  const int* eidx = eidx_all + (size_t)p * 4 * e2p;
  const int lax = 2 * vcap * fp;
  const int inc_ra = 0, inc_rb = 9 * fp, poly_a = 18 * fp, poly_b = poly_a + 3 * ne;
  const int fcnt_a = poly_b + 3 * ne, fcnt_b = fcnt_a + 1, fn_a = fcnt_b + 1, fn_b = fn_a + 3;
  const int off_a = fn_b + 3, off_b = off_a + 1;
  const int fb_a = 0, fb_b = fp, eb_a = 2 * fp, eb_b = 2 * fp + e2p;

  const float* ra = ga.r;
  const float* rb = gb.r;
  float mext[16], dpa[3];
  make_mext(ga, gb, mext, dpa);
  float m9[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) m9[k] = mext[k];

  // ---- the best face and edge axis: the splits' bests in index order
  // (thread t reads splits t, t + kGroup, ...; the lowest split among
  // equal values wins) ----
  float face_sep = -CUDART_INF_F, edge_sep = -CUDART_INF_F;
  int face_split = INT_MAX, edge_split = INT_MAX;
  for (int s = t; s < d.ns_face + d.ns_edge; s += kGroup) {
    const float v = sc.part_v[((size_t)s * d.nb + b) * d.sat_cap + lane];
    if (s < d.ns_face) {
      if (face_split == INT_MAX || v > face_sep) {
        face_sep = v;
        face_split = s;
      }
    } else if (edge_split == INT_MAX || v > edge_sep) {
      edge_sep = v;
      edge_split = s;
    }
  }
  group_argmax<kGroup>(face_sep, face_split, gmask);
  group_argmax<kGroup>(edge_sep, edge_split, gmask);
  const int face_idx = sc.part_i[((size_t)face_split * d.nb + b) * d.sat_cap + lane];
  // no edge axis (d2 = 0): separation 0 at axis 0, as the serial loop starts
  if (d.ns_edge == 0) edge_sep = 0.f;
  const int edge_idx = d.ns_edge ? sc.part_i[((size_t)edge_split * d.nb + b) * d.sat_cap + lane] : 0;

  const bool separated = fmaxf(face_sep, edge_sep) > 0.f;
  if (counts != nullptr && t == 0) {
    atomicAdd(counts, 1ull);
    if (!separated) atomicAdd(counts + 1, 1ull);
  }
  const bool edge_wins = !separated && (edge_sep > face_sep + 1e-4f + 0.05f * fabsf(face_sep));
  const bool ref_is_a = face_idx < fp;
  const int fr = ref_is_a ? face_idx : face_idx - fp;

  // ---- incident face: most anti-parallel face of the other hull ----
  const int inc_base = ref_is_a ? inc_ra : inc_rb;
  const int inc_bias = ref_is_a ? fb_b : fb_a;
  float inc_best = -CUDART_INF_F;
  int fi = INT_MAX;
  for (int o = t; o < fp; o += kGroup) {
    const float al = dot9(c32 + (size_t)(inc_base + o) * fp + fr, (size_t)fp * fp, m9);
    const float val = -(al + __ldg(cb + inc_bias + o));
    if (fi == INT_MAX || val > inc_best) {
      inc_best = val;
      fi = o;
    }
  }
  group_argmax<kGroup>(inc_best, fi, gmask);

  // ---- face polygons (owner frame) → world ----
  const int poly_r = ref_is_a ? poly_a : poly_b, poly_i = ref_is_a ? poly_b : poly_a;
  const int ref_cnt = (int)__ldg(c32 + (size_t)(ref_is_a ? fcnt_a : fcnt_b) * fp + fr);
  const int inc_cnt = (int)__ldg(c32 + (size_t)(ref_is_a ? fcnt_b : fcnt_a) * fp + fi);
  float r_ref[9], r_inc[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    r_ref[k] = ref_is_a ? ra[k] : rb[k];
    r_inc[k] = ref_is_a ? rb[k] : ra[k];
  }
  const V3 p_ref = vsel(ref_is_a, ga.p, gb.p);
  const V3 p_inc = vsel(ref_is_a, gb.p, ga.p);
  V3 ref_w[E], inc_w[E];
  auto to_world = [&](int k) {
    ref_w[k] = inc_w[k] = mk(0.f, 0.f, 0.f);
    if (k >= ne) return;
    const float* pr = c32 + (size_t)(poly_r + k) * fp + fr;
    const float* pi = c32 + (size_t)(poly_i + k) * fp + fi;
    const float x = __ldg(pr), y = __ldg(pr + (size_t)ne * fp), z = __ldg(pr + (size_t)2 * ne * fp);
    ref_w[k] = mk(r_ref[0] * x + r_ref[1] * y + r_ref[2] * z + p_ref.x,
                  r_ref[3] * x + r_ref[4] * y + r_ref[5] * z + p_ref.y,
                  r_ref[6] * x + r_ref[7] * y + r_ref[8] * z + p_ref.z);
    const float xi = __ldg(pi), yi = __ldg(pi + (size_t)ne * fp), zi = __ldg(pi + (size_t)2 * ne * fp);
    inc_w[k] = mk(r_inc[0] * xi + r_inc[1] * yi + r_inc[2] * zi + p_inc.x,
                  r_inc[3] * xi + r_inc[4] * yi + r_inc[5] * zi + p_inc.y,
                  r_inc[6] * xi + r_inc[7] * yi + r_inc[8] * zi + p_inc.z);
  };
  if constexpr (E <= kRegFaceVerts) {
#pragma unroll
    for (int k = 0; k < E; ++k) to_world(k);
  } else {
#pragma unroll 1
    for (int k = 0; k < E; ++k) to_world(k);
  }
  const int fn = ref_is_a ? fn_a : fn_b;
  const V3 nloc = mk(__ldg(c32 + (size_t)fn * fp + fr), __ldg(c32 + (size_t)(fn + 1) * fp + fr),
                     __ldg(c32 + (size_t)(fn + 2) * fp + fr));
  const V3 n_ref = mat_vec(r_ref, nloc);
  const float off_ref = __ldg(c32 + (size_t)(ref_is_a ? off_a : off_b) * fp + fr) + dot(n_ref, p_ref);

  // ---- 2-D clip in the reference-face frame ----
  const V3 edge0 = sub(ref_w[1], ref_w[0]);
  const V3 t1 = scale(edge0, 1.0f / fmaxf(sqrtf(fmaxf(dot(edge0, edge0), 0.f)), 1e-9f));
  const V3 t2 = cross(n_ref, t1);
  const V3 p0 = ref_w[0];
  float ru[E], rv[E];
  float pu[kSl], pv[kSl], ps[kSl];
  auto to_frame = [&](int k) {
    const V3 rel_r = sub(ref_w[k], p0);
    ru[k] = dot(rel_r, t1);
    rv[k] = dot(rel_r, t2);
    const V3 rel = sub(inc_w[k], p0);
    pu[k] = k < ne ? dot(rel, t1) : 0.f;
    pv[k] = k < ne ? dot(rel, t2) : 0.f;
    ps[k] = k < ne ? dot(inc_w[k], n_ref) - off_ref : 0.f;
    pu[E + k] = pv[E + k] = ps[E + k] = 0.f;
  };
  if constexpr (E <= kRegFaceVerts) {
#pragma unroll
    for (int k = 0; k < E; ++k) to_frame(k);
  } else {
#pragma unroll 1
    for (int k = 0; k < E; ++k) to_frame(k);
  }
  int m = inc_cnt;
  // clip against reference edge k (of ref_cnt; the rest are no-ops)
  auto clip_edge = [&](int k) {
    float ru_n = ru[0], rv_n = rv[0];
    if (k + 1 < ne) {
      const bool wrapped = (k + 1) == ref_cnt;
      ru_n = wrapped ? ru[0] : ru[k + 1];
      rv_n = wrapped ? rv[0] : rv[k + 1];
    }
    const float e_u = ru_n - ru[k];
    const float e_v = rv_n - rv[k];
    const float on = k < ref_cnt ? 1.f : 0.f;
    const float dk = (e_v * ru[k] - e_u * rv[k]) * on + (1.f - on) * kBig;
    if constexpr (E <= kRegFaceVerts)
      clip(pu, pv, ps, m, e_v * on, -e_u * on, dk, n_sl);
    else
      clip_serial(pu, pv, ps, m, e_v * on, -e_u * on, dk, n_sl);
  };
  if constexpr (E <= 4) {
#pragma unroll
    for (int k = 0; k < E; ++k)
      if (k < ne) clip_edge(k);
  } else {
#pragma unroll 1
    for (int k = 0; k < ne; ++k) clip_edge(k);
  }
  const V3 n_face = ref_is_a ? neg(n_ref) : n_ref;

  // ---- edge-edge closest-point contact ----
  const int ae = edge_idx;
  const float ax0 = dot16(c16 + (size_t)(lax + ae) * 16, mext);
  const float ax1 = dot16(c16 + (size_t)(lax + d2p + ae) * 16, mext);
  const float ax2 = dot16(c16 + (size_t)(lax + 2 * d2p + ae) * 16, mext);
  const float alen = sqrtf(fmaxf(ax0 * ax0 + ax1 * ax1 + ax2 * ax2, 1e-18f));
  const float t_ax = -(ax0 * dpa[0] + ax1 * dpa[1] + ax2 * dpa[2]);
  const float sgn = t_ax < 0.f ? -1.f : 1.f;
  const V3 ax_u = scale(mk(ax0, ax1, ax2), sgn / fmaxf(alen, 1e-9f));
  const V3 n_edge = mat_vec(ra, ax_u);
  // supports of each vertex on the chosen axis (SAV / SBV rows)
  for (int u = t; u < vcap; u += kGroup) {
    sup[u] = dot9(c88 + (size_t)u * d2p + ae, (size_t)vcap * d2p, m9) * sgn;
    sup[vcap + u] = dot9(c88 + (size_t)(9 * vcap + u) * d2p + ae, (size_t)vcap * d2p, m9) * sgn;
  }
  __syncwarp(gmask);
  // support of vertex u of hull A (side 0) or B (side 1), 0 for no edge
  auto support = [&](int side, int u) -> float { return u < 0 ? 0.f : sup[side * vcap + u]; };
  float best_a = -CUDART_INF_F, best_b = -CUDART_INF_F;
  int ea = INT_MAX, eb = INT_MAX;
  for (int ed = t; ed < e2p; ed += kGroup) {
    const float sa = -(fmaxf(support(0, __ldg(eidx + ed)), support(0, __ldg(eidx + e2p + ed))) +
                       __ldg(cb + eb_a + ed));
    const float sb = fminf(support(1, __ldg(eidx + 2 * e2p + ed)), support(1, __ldg(eidx + 3 * e2p + ed))) -
                     __ldg(cb + eb_b + ed);
    if (ea == INT_MAX || sa > best_a) {
      best_a = sa;
      ea = ed;
    }
    if (eb == INT_MAX || sb > best_b) {
      best_b = sb;
      eb = ed;
    }
  }
  group_argmax<kGroup>(best_a, ea, gmask);
  group_argmax<kGroup>(best_b, eb, gmask);
  const V3 ea0 = add(mat_vec(ra, mk(__ldg(c80 + ea), __ldg(c80 + e2p + ea), __ldg(c80 + 2 * e2p + ea))), ga.p);
  const V3 ea1 =
      add(mat_vec(ra, mk(__ldg(c80 + 3 * e2p + ea), __ldg(c80 + 4 * e2p + ea), __ldg(c80 + 5 * e2p + ea))), ga.p);
  const V3 eb0 =
      add(mat_vec(rb, mk(__ldg(c80 + 6 * e2p + eb), __ldg(c80 + 7 * e2p + eb), __ldg(c80 + 8 * e2p + eb))), gb.p);
  const V3 eb1 =
      add(mat_vec(rb, mk(__ldg(c80 + 9 * e2p + eb), __ldg(c80 + 10 * e2p + eb), __ldg(c80 + 11 * e2p + eb))), gb.p);
  const V3 d1 = sub(ea1, ea0);
  const V3 d2v = sub(eb1, eb0);
  const V3 r0v = sub(ea0, eb0);
  const float a11 = dot(d1, d1);
  const float a22 = dot(d2v, d2v);
  const float a12 = dot(d1, d2v);
  const float b1 = dot(d1, r0v);
  const float b2 = dot(d2v, r0v);
  const float den = a11 * a22 - a12 * a12;
  float sparm = fabsf(den) > 1e-9f ? (a12 * b2 - a22 * b1) / den : 0.f;
  sparm = fminf(fmaxf(sparm, 0.f), 1.f);
  float tparm = a22 > 1e-9f ? (b2 + a12 * sparm) / a22 : 0.f;
  tparm = fminf(fmaxf(tparm, 0.f), 1.f);
  if (a11 > 1e-9f) sparm = fminf(fmaxf((a12 * tparm - b1) / a11, 0.f), 1.f);
  const V3 edge_point = scale(add(add(ea0, scale(d1, sparm)), add(eb0, scale(d2v, tparm))), 0.5f);
  const float edge_depth = -edge_sep;

  // ---- slot scores + top-k ----
  const bool face_ok = !separated && !edge_wins;
  // slots 0 … n_sl − 1 the clip's, n_sl the edge-edge one, the rest unused
  float score[kNs];
  const float edge_score = (edge_wins && (edge_depth > 0.f)) ? edge_depth : -kBig;
  // registers: the clip's slots and the edge slot as arrays of kNs
  constexpr int kR = E <= kRegFaceVerts ? kNs : 1;
  float pu_r[kR], pv_r[kR], ps_r[kR];
  if constexpr (E <= kRegFaceVerts) {
#pragma unroll
    for (int s = 0; s < kSl; ++s) score[s] = ((s < m) && (-ps[s] > 0.f) && face_ok) ? -ps[s] : -kBig;
    score[kSl] = -kBig;
#pragma unroll
    for (int s = 0; s < kNs; ++s) score[s] = s == n_sl ? edge_score : score[s];
#pragma unroll
    for (int s = 0; s < kSl; ++s) {
      pu_r[s] = pu[s];
      pv_r[s] = pv[s];
      ps_r[s] = ps[s];
    }
    pu_r[kSl] = pv_r[kSl] = ps_r[kSl] = 0.f;
  } else {
    // slots above n_sl score −kBig and never win the first-index argmax
#pragma unroll 1
    for (int s = 0; s <= n_sl; ++s)
      score[s] = s == n_sl ? edge_score : (((s < m) && (-ps[s] > 0.f) && face_ok) ? -ps[s] : -kBig);
  }
  for (int pick = 0; pick < d.kk; ++pick) {
    float best, u, v, s;
    int bidx;
    if constexpr (E <= kRegFaceVerts) {
      argmax(score, best, bidx);
      u = select(bidx, pu_r), v = select(bidx, pv_r), s = select(bidx, ps_r);
    } else {
      best = score[0];
      bidx = 0;
#pragma unroll 1
      for (int k = 1; k <= n_sl; ++k) {
        if (score[k] > best) {
          best = score[k];
          bidx = k;
        }
      }
      u = bidx < kSl ? pu[bidx] : 0.f, v = bidx < kSl ? pv[bidx] : 0.f, s = bidx < kSl ? ps[bidx] : 0.f;
    }
    const bool act = best > 0.f;
    const bool is_edge = bidx == n_sl;
    const V3 face_pt = mk(p0.x + u * t1.x + v * t2.x + s * n_ref.x, p0.y + u * t1.y + v * t2.y + s * n_ref.y,
                          p0.z + u * t1.z + v * t2.z + s * n_ref.z);
    const V3 pt = vsel(is_edge, edge_point, face_pt);
    const V3 nrm = vsel(is_edge, n_edge, n_face);
    const size_t e = e0 + (size_t)pick * d.sat_cap;
    if (t == 0) {
      em_i[e] = act ? 1 : 0;
      em_f[e] = pt.x;
      em_f[n_em + e] = pt.y;
      em_f[2 * n_em + e] = pt.z;
      em_f[3 * n_em + e] = nrm.x;
      em_f[4 * n_em + e] = nrm.y;
      em_f[5 * n_em + e] = nrm.z;
      em_f[6 * n_em + e] = act ? best : 0.f;
      em_f[7 * n_em + e] = (float)bidx;
    }
    if constexpr (E <= kRegFaceVerts) {
#pragma unroll
      for (int k = 0; k < kNs; ++k) score[k] = bidx == k ? -kBig : score[k];
    } else {
      score[bidx] = -kBig;
    }
  }
}

// ---------------------------------------------------------------------------
// 4. ground: the kg lowest vertices of each rank below the plane
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kWarps * 32)
hull_ground_kernel(const float* __restrict__ geom, const float* __restrict__ gv, const float* __restrict__ vbias,
                   Scratch sc, Dims d) {
  // one warp per rank: thread t scores vertices t, t + 32, ... once; each
  // pick is a warp_argmax over the vertices not taken yet
  const int t = threadIdx.x & 31;
  const int b = blockIdx.y;
  const int r = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= kBlock) return;
  const int start = (d.bucket0 + b) * kBlock;
  const size_t n_g = (size_t)d.nb * d.kg * kBlock;
  const int vs = (d.vcap + 7) / 8 * 8;
  const Hull gl = load_hull(geom, d.npad, start + r);
  const bool tok = (gl.typ > 0.5f) && (gl.typ < (float)d.h + 0.5f);
  int tq = (int)rintf(gl.typ) - 1;
  tq = tq < 0 ? 0 : (tq > d.h - 1 ? d.h - 1 : tq);
  const float* vrow = gv + (size_t)tq * vs * 3;
  const float* vb = vbias + (size_t)tq * vs;
  const bool mv = gl.movable > 0.f;
  float score[4];   // vertices t + 32k (vcap ≤ 128)
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int v = t + 32 * k;
    score[k] = -kBig;
    if (v < d.vcap) {
      const float lx = tok ? __ldg(vrow + 3 * v) : 0.f;
      const float ly = tok ? __ldg(vrow + 3 * v + 1) : 0.f;
      const float lz = tok ? __ldg(vrow + 3 * v + 2) : 0.f;
      const float vbl = tok ? __ldg(vb + v) : 0.f;
      float wy = lx * gl.r[3] + ly * gl.r[4] + lz * gl.r[5];
      wy = wy + gl.p.y;
      const float depth = d.gh - wy;
      score[k] = (mv && (depth > 0.f)) ? depth + vbl : -kBig;
    }
  }
  unsigned taken = 0u;   // bit k: vertex t + 32k picked
  for (int pick = 0; pick < d.kg; ++pick) {
    float best = -CUDART_INF_F;
    int vidx = INT_MAX;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int v = t + 32 * k;
      if (v < d.vcap) {
        const float g = ((taken >> k) & 1u) ? -kBig : score[k];
        if (vidx == INT_MAX || g > best) {
          best = g;
          vidx = v;
        }
      }
    }
    warp_argmax(best, vidx);
    if ((vidx & 31) == t) taken |= 1u << (vidx >> 5);
    if (t != 0) continue;
    const bool act = best > 0.f;
    const float lx = tok ? __ldg(vrow + 3 * vidx) : 0.f;
    const float ly = tok ? __ldg(vrow + 3 * vidx + 1) : 0.f;
    const float lz = tok ? __ldg(vrow + 3 * vidx + 2) : 0.f;
    const size_t ge = ((size_t)b * d.kg + pick) * kBlock + r;
    float* gr = sc.gnd_f + ge;
    gr[0] = gl.p.x + gl.r[0] * lx + gl.r[1] * ly + gl.r[2] * lz;
    gr[n_g] = gl.p.y + gl.r[3] * lx + gl.r[4] * ly + gl.r[5] * lz;
    gr[2 * n_g] = gl.p.z + gl.r[6] * lx + gl.r[7] * ly + gl.r[8] * lz;
    gr[3 * n_g] = lx;
    gr[4 * n_g] = ly;
    gr[5 * n_g] = lz;
    gr[6 * n_g] = act ? best : 0.f;
    gr[7 * n_g] = (float)vidx;
    sc.gnd_i[ge] = act ? 1 : 0;
  }
}

// ---------------------------------------------------------------------------
// 5. stable compaction of the emissions into ccap slots, meta counters; the
//    previous keys for the warm match
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kScanThreads)
hull_scan_kernel(const float* __restrict__ pcols, Scratch sc, float* __restrict__ meta, Dims d) {
  __shared__ int warp_sums[32];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  if (pcols != nullptr)
    compact_prev_keys(pcols + (size_t)b * d.ccap * 8, sc.prev + (size_t)b * d.ccap, sc.n_prev + b, d.ccap);
  const int n_pair_e = d.kk * d.sat_cap;
  const int e_tot = n_pair_e + d.kg * kBlock;
  const int* em_i = sc.em_i + (size_t)b * n_pair_e;
  const int* gnd_i = sc.gnd_i + (size_t)b * d.kg * kBlock;
  int* slot = sc.slot + (size_t)b * e_tot;
  int n_act = 0;
  for (int e0 = 0; e0 < e_tot; e0 += blockDim.x) {
    const int e = e0 + tid;
    int flag = 0;
    if (e < n_pair_e) flag = em_i[e];
    else if (e < e_tot) flag = gnd_i[e - n_pair_e];
    int total;
    const int pos = n_act + block_exclusive_scan(flag, warp_sums, total);
    if (e < e_tot) slot[e] = flag ? pos : -1;
    n_act += total;
  }
  if (tid == 0) sc.nact[b] = n_act;
  // meta: dropped, active, prefilter drops
  for (int i = tid; i < 8 * kBlock; i += blockDim.x) {
    const int r = i / kBlock, c = i % kBlock;
    float val = 0.f;
    if (r == 0 && c == 0) val = (float)(n_act > d.ccap ? n_act - d.ccap : 0);
    if (r == 0 && c == 1) val = (float)n_act;
    if (r == 0 && c == 2) val = (float)sc.dropped2[b];
    meta[(size_t)r * d.nb * kBlock + (size_t)b * kBlock + c] = val;
  }
}

// ---------------------------------------------------------------------------
// 6. table rows with body-frame anchors, warm keys; empty slots zeroed
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kRowThreads)
hull_rows_kernel(const float* __restrict__ geom, Scratch sc, float* __restrict__ table, Dims d) {
  const int b = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int start = (d.bucket0 + b) * kBlock;
  const int n_pair_e = d.kk * d.sat_cap;
  const int e_tot = n_pair_e + d.kg * kBlock;
  const size_t cp = (size_t)d.nb * d.ccap;
  const size_t n_em = (size_t)d.nb * n_pair_e;
  const size_t n_g = (size_t)d.nb * d.kg * kBlock;
  const int n_act = sc.nact[b];
  const int kept = n_act < d.ccap ? n_act : d.ccap;
  float* out = table + (size_t)b * d.ccap;
  if (i < d.ccap && i >= kept)
    for (int k = 0; k < d.rows; ++k) out[(size_t)k * cp + i] = 0.f;
  if (i >= e_tot) return;
  const int sl = sc.slot[(size_t)b * e_tot + i];
  if (sl < 0 || sl >= d.ccap) return;
  float v[32];
  V3 pt, a_loc, b_loc, n_loc;
  v[9] = 1.f;
  if (i < n_pair_e) {
    const size_t k = (size_t)b * n_pair_e + i;
    const float* em_f = sc.em_f;
    pt = mk(em_f[k], em_f[n_em + k], em_f[2 * n_em + k]);
    const V3 n = mk(em_f[3 * n_em + k], em_f[4 * n_em + k], em_f[5 * n_em + k]);
    const int lane = i % d.sat_cap;
    const int la = sc.lanes[(size_t)b * d.sat_cap + lane];
    const int lb = sc.lanes[((size_t)d.nb + b) * d.sat_cap + lane];
    const Hull ga = load_hull(geom, d.npad, start + la);
    const Hull gb = load_hull(geom, d.npad, start + lb);
    v[3] = n.x;
    v[4] = n.y;
    v[5] = n.z;
    v[6] = em_f[6 * n_em + k];
    v[7] = sqrtf(ga.fric * gb.fric);
    v[8] = fmaxf(ga.rest, gb.rest);
    const int ia = (int)ga.id, ib = (int)gb.id;
    v[10] = (float)(ia > ib ? ia : ib);
    v[11] = (float)(ia < ib ? ia : ib);
    v[12] = 0.f;
    v[13] = (float)(start + la);
    v[14] = (float)(start + lb + 1);
    v[15] = em_f[7 * n_em + k];
    a_loc = t_apply(ga.r, sub(pt, ga.p));
    b_loc = t_apply(gb.r, sub(pt, gb.p));
    n_loc = t_apply(ga.r, n);
  } else {
    const int ge = i - n_pair_e;
    const int r = ge % kBlock;
    const Hull gl = load_hull(geom, d.npad, start + r);
    const float* gr = sc.gnd_f + (size_t)b * d.kg * kBlock + ge;
    pt = mk(gr[0], gr[n_g], gr[2 * n_g]);
    v[3] = 0.f;
    v[4] = 1.f;
    v[5] = 0.f;
    v[6] = gr[6 * n_g];
    v[7] = gl.fric;
    v[8] = gl.rest;
    v[10] = gl.id;
    v[11] = 0.f;
    v[12] = 1.f;
    v[13] = (float)(start + r);
    v[14] = 0.f;
    v[15] = gr[7 * n_g];
    a_loc = mk(gr[3 * n_g], gr[4 * n_g], gr[5 * n_g]);
    b_loc = pt;
    n_loc = mk(gl.r[3], gl.r[4], gl.r[5]);
  }
  v[0] = pt.x;
  v[1] = pt.y;
  v[2] = pt.z;
  v[16] = a_loc.x;
  v[17] = a_loc.y;
  v[18] = a_loc.z;
  v[19] = b_loc.x;
  v[20] = b_loc.y;
  v[21] = b_loc.z;
  v[22] = n_loc.x;
  v[23] = n_loc.y;
  v[24] = n_loc.z;
#pragma unroll
  for (int k = 25; k < 32; ++k) v[k] = 0.f;
#pragma unroll
  for (int k = 0; k < 32; ++k)
    if (k < d.rows) out[(size_t)k * cp + sl] = v[k];
  sc.keys[(size_t)b * d.ccap + sl] = v[10] + 65536.0f * (2.0f * v[15] + v[12]) + 2.0f * (v[9] - 1.0f);
  sc.keys[cp + (size_t)b * d.ccap + sl] = v[11];
}

}  // namespace

// Words (4 bytes) of int32 scratch the table call needs.
extern "C" int ht_scratch_words(int nb, int sat_cap, int kk, int kg, int ccap, int fp, int d2) {
  Dims d;
  d.nb = nb;
  d.sat_cap = sat_cap;
  d.kk = kk;
  d.kg = kg;
  d.ccap = ccap;
  d.ns_face = (2 * fp + kFacesPerSplit - 1) / kFacesPerSplit;
  d.ns_edge = (d2 + kAxesPerSplit - 1) / kAxesPerSplit;
  const size_t w = carve_scratch(nullptr, d).words;
  return w > 0x7fffffff ? -1 : (int)w;
}

extern "C" int ht_bucket_hull_contact_table(const float* geom, const int* la, const int* lb, const float* pcols,
                                            const float* c16, const float* c32, const float* c88,
                                            const float* c80, const float* cb, const int* eidx, const float* gv,
                                            const float* vbias, float* table, float* meta, float* warm,
                                            int* scratch, int scratch_words, int nb,
                                            int bucket0, int cap, int cap2, int ccap, int kk, int kg, int npad, int rows, int h, int fp,
                                            int vcap, int e, int d2, int d2p, int e2p, int r16, int r32, int rcb,
                                            float gh, long long* counts, void* stream) {
  if (e < 1 || e > kMaxFaceVerts || 2 * e + 1 > 128 || kk > 2 * e + 1 || kg > 8 || kg > vcap || vcap > 128 || rows > 32 || (cap2 && cap2 > cap) || h < 1 || h * h > 31 ||
      ((uintptr_t)c16 & 15) || bucket0 < 0 || (size_t)(bucket0 + nb + 2) * kBlock > (size_t)npad ||
      ccap % 128)
    return (int)cudaErrorInvalidValue;
  Dims d;
  d.nb = nb;
  d.bucket0 = bucket0;
  d.cap = cap;
  d.cap2 = cap2;
  d.sat_cap = cap2 ? cap2 : cap;
  d.ccap = ccap;
  d.kk = kk;
  d.kg = kg;
  d.npad = npad;
  d.rows = rows;
  d.h = h;
  d.fp = fp;
  d.vcap = vcap;
  d.e = e;
  d.d2 = d2;
  d.d2p = d2p;
  d.e2p = e2p;
  d.r16 = r16;
  d.r32 = r32;
  d.rcb = rcb;
  d.ns_face = (2 * fp + kFacesPerSplit - 1) / kFacesPerSplit;
  d.ns_edge = (d2 + kAxesPerSplit - 1) / kAxesPerSplit;
  d.gh = gh;
  const Scratch sc = carve_scratch(scratch, d);
  if (sc.words > (size_t)scratch_words) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;

  hull_prefilter_kernel<<<nb, kThreads, 0, st>>>(geom, la, lb, sc.lanes, sc.dropped2, d);

  const size_t sat_smem = (size_t)sat_split_rows(vcap) * 64;
  err = cudaFuncSetAttribute(hull_sat_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sat_smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 sat_grid((d.sat_cap + kSatThreads - 1) / kSatThreads, nb, d.ns_face + d.ns_edge);
  hull_sat_kernel<<<sat_grid, kSatThreads, sat_smem, st>>>(geom, c16, sc, d);

  constexpr int lanes_per_block = kManThreads / kGroup;
  const dim3 lane_grid((d.sat_cap + lanes_per_block - 1) / lanes_per_block, nb);
  const size_t sup_smem = (size_t)lanes_per_block * 2 * vcap * 4;
  auto manifold = e <= 4    ? hull_manifold_kernel<4>
                  : e <= 8  ? hull_manifold_kernel<8>
                  : e <= 16 ? hull_manifold_kernel<16>
                  : e <= 32 ? hull_manifold_kernel<32>
                            : hull_manifold_kernel<kMaxFaceVerts>;
  manifold<<<lane_grid, kManThreads, sup_smem, st>>>(geom, c16, c32, c88, c80, cb, eidx,
                                                     reinterpret_cast<unsigned long long*>(counts), sc, d);

  if (kg > 0)
    hull_ground_kernel<<<dim3(kBlock / kWarps, nb), kWarps * 32, 0, st>>>(geom, gv, vbias, sc, d);

  hull_scan_kernel<<<nb, kScanThreads, 0, st>>>(pcols, sc, meta, d);

  const int e_tot = kk * d.sat_cap + kg * kBlock;
  const int row_items = e_tot > ccap ? e_tot : ccap;
  hull_rows_kernel<<<dim3((row_items + kRowThreads - 1) / kRowThreads, nb), kRowThreads, 0, st>>>(geom, sc, table,
                                                                                                 d);
  if (pcols != nullptr) {
    err = launch_warm_match<hull_table_warm>(pcols, sc.prev, sc.n_prev, sc.keys, sc.nact, warm, nb, ccap, st);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}
