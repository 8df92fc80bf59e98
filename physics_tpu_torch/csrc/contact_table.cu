// Fused bucket-aligned contact table for box piles and packed envs
// (Hopper, sm_90a).
//
// Replaces the TPU kernel bucket_contact_table
// (physics_tpu/ops/contact_table.py:844, body _make_ct_kernel :166-747), all
// four of its modes. Plain version: physics_tpu_torch/ops/contact_table.py
// bucket_contact_table_plain, whose narrow phase is ops/boxbox_batched.py;
// the kernel below and its box-box manifold (boxbox.cuh, shared with the
// banded pair-manifold kernel) compute the same operations in the same order.
//
// One block per bucket of 128 ranks; a call builds the nb buckets from
// bucket0 on (all of them, or one rank's range in the row-sharded step), and
// its outputs are that range's blocks:
//   0. with bp_k > 0, the in-kernel broad phase instead of candidate lanes:
//      the window AABBs (|R|·half extents) of the bucket's 128 + bp_k ranks
//      in shared memory, then a thread per raw pair (a, a + d), d-major,
//      tested (AABB overlap, both live, one movable; with env_k both in one
//      env) and compacted, order preserved, into `cap` lanes by the block
//      scan; the same scan counts the ranks still overlapping at d = bp_k;
//   1. face-axis SAT prefilter over the bucket's `cap` candidate lanes;
//      survivors compacted, order preserved, into `cap2` lanes (block scan);
//   2. the 15-axis box-box manifold per surviving lane (one lane per thread),
//      and its `kk` deepest points;
//   3. up to `kg` ground corners per rank of the bucket;
//   4. a block-wide exclusive scan over the emissions in the reference's
//      order (pick-major over the pair lanes, then pick-major over the 128
//      ranks) gives each active contact its slot; slots >= ccap are dropped
//      and counted;
//   5. each slot's warm-start impulse: the previous step's contact of this
//      bucket with the same feature key (keys are unique per bucket), a
//      warp scanning the previous slots by ballots for its slots in turn,
//      empty slots skipped and the scan ending at the last previous slot
//      that can match (2.4's warm kernel does the same).
// With a gate (the displacement-gated refresh), a bucket whose gate is 0
// skips 0-4: it copies its persisted block, writes zero meta, and runs 5 on
// the copy, which carries each slot's λ by identity.
//
// Shared memory: a ground emission keeps only its flag and corner (the row
// writer recomputes the corner, bit for bit), and a pair emission's slot id
// rides in its flag word, so the packed envs' bucket (896 lanes of 8 picks,
// 8 ground picks, 768 slots) needs 191 KB rather than 236 KB, within the
// 227 KB a block can have; a larger working set is refused at launch.
//
// What bounds it on the H100: a block holds up to 191 KB of shared memory
// and 255 registers a thread, so an SM runs one; the 4k pile's 32 buckets
// use 32 SMs and the packed envs' 256 take two waves, each block
// latency-bound on its 8 warps (the manifold is ~2k dependent flops a lane;
// the warm match is a ballot scan a slot, bounded as 5 says). The design
// keeps all per-contact intermediates in shared memory (no HBM round trip
// between phases) and reads geometry straight from the [48, NPAD] table by
// rank (L2-resident). Spreading a bucket over more blocks is later work.
//
// The TPU kernel's one-hot matmuls, hi/lo bf16 splits, strided lane rolls and
// triangular-matmul prefix sums are not ported: gathers are loads and the
// scans are warp scans.

#include <cstdint>

#include "boxbox.cuh"

namespace {

constexpr int kBlock = 128;      // ranks per bucket
constexpr int kThreads = 256;
constexpr int kGeomRow0 = 24;    // narrow-phase block of the unified table
constexpr int kSmemTooLarge = 1001;  // _build.SMEM_TOO_LARGE

struct Dims {
  int nb, bucket0, cap, cap2, sat_cap, ccap, kk, kg, npad, rows, bp_k, env_k;
  float gh;
};

struct Smem {
  int* la1;      // [cap] in-kernel broad phase lanes (la2 when no cap2)
  int* lb1;
  int* la2;      // [sat_cap]
  int* lb2;
  int* slot;     // [E] activity | slot id << 1, then table slot << 3 | slot id (or -1)
  float* pt;     // [3 * pair emissions]
  float* dep;    // [pair emissions]
  float* lane_n; // [3 * sat_cap]
  float* box;    // [8 * (128 + bp_k)]: window AABB min xyz, max xyz, live, movable
  float* ck;     // [ccap]
  float* ch;     // [ccap]
  float* prev;   // [5 * ccap]: ck, KH, λ0 xyz of the previous block
  int* warp_sums;// [32]
  int* n_prev;   // [1] the warm match's scan bound
  size_t words;
};

__host__ __device__ inline Smem carve(char* base, const Dims& d, bool warm) {
  const size_t n_pair_e = (size_t)d.kk * d.sat_cap;
  const size_t e_tot = n_pair_e + (size_t)d.kg * kBlock;
  const bool split = d.bp_k && d.cap2;   // stage-1 lanes of their own
  Smem s;
  int* ip = reinterpret_cast<int*>(base);
  size_t off = 0;
  auto take = [&](size_t words) {
    int* p = ip ? ip + off : nullptr;
    off += words;
    return p;
  };
  s.la2 = take(d.sat_cap);
  s.lb2 = take(d.sat_cap);
  s.la1 = split ? take(d.cap) : s.la2;
  s.lb1 = split ? take(d.cap) : s.lb2;
  s.slot = take(e_tot);
  s.pt = reinterpret_cast<float*>(take(3 * n_pair_e));
  s.dep = reinterpret_cast<float*>(take(n_pair_e));
  s.lane_n = reinterpret_cast<float*>(take(3 * (size_t)d.sat_cap));
  s.box = reinterpret_cast<float*>(take(d.bp_k ? 8 * (size_t)(kBlock + d.bp_k) : 0));
  s.ck = reinterpret_cast<float*>(take(d.ccap));
  s.ch = reinterpret_cast<float*>(take(d.ccap));
  s.prev = reinterpret_cast<float*>(take(warm ? 5 * (size_t)d.ccap : 0));
  s.warp_sums = take(32);
  s.n_prev = take(1);
  s.words = off;
  return s;
}

// Corner c (bit 2: +x, bit 1: +y, bit 0: +z) of box gl in world.
__device__ __forceinline__ V3 box_corner(const Box& gl, int c) {
  const float sx = (c & 4) ? 1.f : -1.f;
  const float sy = (c & 2) ? 1.f : -1.f;
  const float sz = (c & 1) ? 1.f : -1.f;
  const float wx = sx * gl.h.x, wy = sy * gl.h.y, wz = sz * gl.h.z;
  return mk(gl.p.x + gl.r[0] * wx + gl.r[1] * wy + gl.r[2] * wz,
            gl.p.y + gl.r[3] * wx + gl.r[4] * wy + gl.r[5] * wz,
            gl.p.z + gl.r[6] * wx + gl.r[7] * wy + gl.r[8] * wz);
}

// The warm key of a slot from its table rows (ACT, KL, KH, KSGN, KS).
__device__ __forceinline__ float warm_key(float act, float kl, float ksgn, float ks) {
  return kl + 65536.0f * (2.0f * ks + ksgn) + 2.0f * (act - 1.0f);
}

// Phase 0: the in-kernel broad phase into la1/lb1 [cap]. Returns the raw
// survivors beyond cap; *winovf gets the ranks overlapping at d = bp_k.
__device__ int inkernel_candidates(const float* geom, const Dims& d, int start, const Smem& s, int* winovf) {
  const int tid = threadIdx.x;
  const int wl = kBlock + d.bp_k;
  for (int l = tid; l < wl; l += blockDim.x) {
    const Box g = load_box(geom, d.npad, start + l);
    const float* gc = geom + start + l;
    float* bx = s.box + 8 * l;
    const float hv[3] = {g.h.x, g.h.y, g.h.z};
    const float pv[3] = {g.p.x, g.p.y, g.p.z};
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float e = fabsf(g.r[3 * c]) * hv[0];
      e = e + fabsf(g.r[3 * c + 1]) * hv[1];
      e = e + fabsf(g.r[3 * c + 2]) * hv[2];
      bx[c] = pv[c] - e;
      bx[3 + c] = pv[c] + e;
    }
    bx[6] = gc[19 * (size_t)d.npad];   // is_shape (live)
    bx[7] = g.movable;
  }
  for (int i = tid; i < d.cap; i += blockDim.x) s.la1[i] = s.lb1[i] = -1;
  __syncthreads();
  const int items = d.bp_k * kBlock;
  int offset = 0, ovf = 0;
  for (int q0 = 0; q0 < items; q0 += blockDim.x) {
    const int q = q0 + tid;
    int keep = 0, ov = 0, a = 0, bb = 0;
    if (q < items) {
      const int dd = q / kBlock + 1;
      a = q % kBlock;
      bb = a + dd;
      const float* A = s.box + 8 * a;
      const float* B = s.box + 8 * bb;
      const bool x_ov = B[0] <= A[3];
      bool k = x_ov;
#pragma unroll
      for (int c = 0; c < 3; ++c) k = k && (fmaxf(A[c], B[c]) <= fminf(A[3 + c], B[3 + c]));
      const bool live = (A[6] > 0.f) && (B[6] > 0.f);
      k = k && live && ((A[7] > 0.f) || (B[7] > 0.f));
      if (d.env_k) {
        k = k && ((a % d.env_k) + dd < d.env_k);
      } else {
        ov = (dd == d.bp_k) && x_ov && live;
      }
      keep = k;
    }
    // one scan for both counts: survivors in the low 16 bits, window-edge
    // ranks above (each at most blockDim.x a chunk)
    int total;
    const int pos = offset + (block_exclusive_scan(keep | (ov << 16), s.warp_sums, total) & 0xffff);
    if (keep && pos < d.cap) {
      s.la1[pos] = a;
      s.lb1[pos] = bb;
    }
    offset += total & 0xffff;
    ovf += total >> 16;
  }
  *winovf = ovf;
  return offset > d.cap ? offset - d.cap : 0;
}

__global__ void __launch_bounds__(kThreads, 1)
contact_table_kernel(const float* __restrict__ geom_all, const int* __restrict__ la_in, const int* __restrict__ lb_in,
                     const float* __restrict__ pcols, const int* __restrict__ gate,
                     const float* __restrict__ prev_table, float* __restrict__ table, float* __restrict__ meta,
                     float* __restrict__ warm, Dims d) {
  extern __shared__ __align__(16) char smem_raw[];
  const float* geom = geom_all + (size_t)kGeomRow0 * d.npad;  // the boxes' rows
  const int b = blockIdx.x;  // the bucket within the range: outputs and candidates
  const int tid = threadIdx.x;
  const int start = (d.bucket0 + b) * kBlock;  // its first rank
  const int sat_cap = d.sat_cap;
  const int kk = d.kk, kg = d.kg, ccap = d.ccap, rows = d.rows;
  const int n_pair_e = kk * sat_cap;
  const int e_tot = n_pair_e + kg * kBlock;
  const bool has_warm = pcols != nullptr;
  const size_t cp = (size_t)d.nb * ccap;
  const Smem s = carve(smem_raw, d, has_warm);
  float* out = table + (size_t)b * ccap;
  if (tid == 0) *s.n_prev = 0;

  if (gate != nullptr && gate[b] <= 0) {
    // ---- passed through: the persisted block, zero meta ----
    const float* src = prev_table + (size_t)b * ccap;
    for (int j = tid; j < ccap; j += blockDim.x) {
      for (int k = 0; k < rows; ++k) out[(size_t)k * cp + j] = src[(size_t)k * cp + j];
      s.ck[j] = warm_key(src[9 * cp + j], src[10 * cp + j], src[12 * cp + j], src[15 * cp + j]);
      s.ch[j] = src[11 * cp + j];
    }
    for (int i = tid; i < 8 * kBlock; i += blockDim.x)
      meta[(size_t)(i / kBlock) * d.nb * kBlock + (size_t)b * kBlock + i % kBlock] = 0.f;
  } else {
    // ---- phase 0: the in-kernel broad phase (bp_k > 0) ----
    int dropped_bp = 0, winovf = 0;
    const int* src_a = la_in + (size_t)b * d.cap;
    const int* src_b = lb_in + (size_t)b * d.cap;
    if (d.bp_k) {
      dropped_bp = inkernel_candidates(geom, d, start, s, &winovf);
      __syncthreads();
      src_a = s.la1;
      src_b = s.lb1;
    }

    // ---- phase 1: prefilter + order-preserving compaction to cap2 lanes ----
    int dropped2 = 0;
    if (d.cap2) {
      for (int i = tid; i < sat_cap; i += blockDim.x) s.la2[i] = s.lb2[i] = -1;
      __syncthreads();
      int offset = 0;
      for (int c0 = 0; c0 < d.cap; c0 += blockDim.x) {
        const int c = c0 + tid;
        int la = -1, lb = -1, keep = 0;
        if (c < d.cap) {
          la = src_a[c];
          lb = src_b[c];
          if (la >= 0) {
            const Box ga = load_box(geom, d.npad, start + la);
            const Box gb = lb >= 0 ? load_box(geom, d.npad, start + lb) : zero_box();
            const float sep = face_sat_sep(sub(gb.p, ga.p), ga.r, gb.r, ga.h, gb.h);
            keep = (sep < 0.f) && ((ga.movable > 0.f) || (gb.movable > 0.f));
          }
        }
        int total;
        const int pos = offset + block_exclusive_scan(keep, s.warp_sums, total);
        if (keep && pos < d.cap2) {
          s.la2[pos] = la;
          s.lb2[pos] = lb;
        }
        offset += total;
      }
      dropped2 = offset > d.cap2 ? offset - d.cap2 : 0;
    } else if (!d.bp_k) {
      for (int i = tid; i < sat_cap; i += blockDim.x) {
        s.la2[i] = src_a[i];
        s.lb2[i] = src_b[i];
      }
    }
    dropped2 += dropped_bp;   // raw → cap drops, then cap → cap2 drops
    for (int j = tid; j < ccap; j += blockDim.x) {
      s.ck[j] = -2.f;  // inactive fresh slot key: KL = KS = KSGN = 0, ACT = 0
      s.ch[j] = 0.f;
    }
    __syncthreads();

    // ---- phase 2: manifolds and their kk deepest points ----
    for (int lane = tid; lane < sat_cap; lane += blockDim.x) {
      const int la = s.la2[lane];
      const int lb = s.lb2[lane];
      float score[kCap];
      V3 pts[kCap];
      V3 nrm = mk(0.f, 0.f, 0.f);
#pragma unroll
      for (int k = 0; k < kCap; ++k) score[k] = kBigNeg;
      if (la >= 0) {
        const Box ga = load_box(geom, d.npad, start + la);
        const Box gb = lb >= 0 ? load_box(geom, d.npad, start + lb) : zero_box();
        float depth[kCap];
        bool valid[kCap];
        box_box_manifold(ga, gb, pts, depth, valid, nrm);
        const bool movable = (ga.movable > 0.f) || (gb.movable > 0.f);
#pragma unroll
        for (int k = 0; k < kCap; ++k) score[k] = (valid[k] && movable) ? depth[k] : kBigNeg;
      } else {
#pragma unroll
        for (int k = 0; k < kCap; ++k) pts[k] = nrm;
      }
      s.lane_n[3 * lane + 0] = nrm.x;
      s.lane_n[3 * lane + 1] = nrm.y;
      s.lane_n[3 * lane + 2] = nrm.z;
      for (int pick = 0; pick < kk; ++pick) {
        float best;
        int bidx;
        argmax(score, best, bidx);
        const bool act = best > 0.f;
        const V3 pt = select(bidx, pts);
        const int e = pick * sat_cap + lane;
        s.slot[e] = (act ? 1 : 0) | (bidx << 1);
        s.pt[3 * e + 0] = pt.x;
        s.pt[3 * e + 1] = pt.y;
        s.pt[3 * e + 2] = pt.z;
        s.dep[e] = act ? best : 0.f;
#pragma unroll
        for (int k = 0; k < kCap; ++k) score[k] = bidx == k ? kBigNeg : score[k];
      }
    }

    // ---- phase 3: ground corners of the bucket's own ranks ----
    if (kg > 0) {
      for (int r = tid; r < kBlock; r += blockDim.x) {
        const Box gl = load_box(geom, d.npad, start + r);
        const bool mv = gl.movable > 0.f;
        float gsc[8];
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const float dep = d.gh - box_corner(gl, c).y;
          gsc[c] = (mv && (dep > 0.f)) ? dep : kBigNeg;
        }
        for (int pick = 0; pick < kg; ++pick) {
          float best;
          int bidx;
          argmax(gsc, best, bidx);
          s.slot[n_pair_e + pick * kBlock + r] = (best > 0.f ? 1 : 0) | (bidx << 1);
#pragma unroll
          for (int c = 0; c < 8; ++c) gsc[c] = bidx == c ? kBigNeg : gsc[c];
        }
      }
    }
    __syncthreads();

    // ---- phase 4: stable compaction of the emissions into ccap slots ----
    int n_act = 0;
    for (int e0 = 0; e0 < e_tot; e0 += blockDim.x) {
      const int e = e0 + tid;
      const int word = e < e_tot ? s.slot[e] : 0;
      const int flag = word & 1;
      int total;
      const int pos = n_act + block_exclusive_scan(flag, s.warp_sums, total);
      if (e < e_tot) s.slot[e] = flag ? (pos << 3) | (word >> 1) : -1;
      n_act += total;
    }
    __syncthreads();

    for (int e = tid; e < e_tot; e += blockDim.x) {
      const int word = s.slot[e];
      const int sl = word >> 3;
      if (word < 0 || sl >= ccap) continue;
      const int ks = word & 7;
      float v[32];
      V3 pt, a_loc, b_loc, n_loc;
      v[9] = 1.f;
      v[15] = (float)ks;
      if (e < n_pair_e) {
        const int lane = e % sat_cap;
        const int la = s.la2[lane];
        const int lb = s.lb2[lane];
        const Box ga = load_box(geom, d.npad, start + la);
        const Box gb = lb >= 0 ? load_box(geom, d.npad, start + lb) : zero_box();
        const V3 n = mk(s.lane_n[3 * lane], s.lane_n[3 * lane + 1], s.lane_n[3 * lane + 2]);
        pt = mk(s.pt[3 * e], s.pt[3 * e + 1], s.pt[3 * e + 2]);
        v[3] = n.x;
        v[4] = n.y;
        v[5] = n.z;
        v[6] = s.dep[e];
        v[7] = sqrtf(ga.fric * gb.fric);
        v[8] = fmaxf(ga.rest, gb.rest);
        const int ia = (int)ga.id, ib = (int)gb.id;
        v[10] = (float)(ia > ib ? ia : ib);
        v[11] = (float)(ia < ib ? ia : ib);
        v[12] = 0.f;
        v[13] = (float)(start + la);
        v[14] = (float)(start + lb + 1);
        a_loc = t_apply(ga.r, sub(pt, ga.p));
        b_loc = t_apply(gb.r, sub(pt, gb.p));
        n_loc = t_apply(ga.r, n);
      } else {
        const int r = (e - n_pair_e) % kBlock;
        const Box gl = load_box(geom, d.npad, start + r);
        pt = box_corner(gl, ks);
        v[3] = 0.f;
        v[4] = 1.f;
        v[5] = 0.f;
        v[6] = d.gh - pt.y;
        v[7] = gl.fric;
        v[8] = gl.rest;
        v[10] = gl.id;
        v[11] = 0.f;
        v[12] = 1.f;
        v[13] = (float)(start + r);
        v[14] = 0.f;
        a_loc = t_apply(gl.r, sub(pt, gl.p));
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
      for (int k = 0; k < rows; ++k) out[(size_t)k * cp + sl] = v[k];
      s.ck[sl] = warm_key(v[9], v[10], v[12], v[15]);
      s.ch[sl] = v[11];
    }
    const int kept = n_act < ccap ? n_act : ccap;
    for (int j = kept + tid; j < ccap; j += blockDim.x)
      for (int k = 0; k < rows; ++k) out[(size_t)k * cp + j] = 0.f;

    // ---- meta: dropped, active, lane drops, window-edge ranks ----
    for (int i = tid; i < 8 * kBlock; i += blockDim.x) {
      const int r = i / kBlock, c = i % kBlock;
      float val = 0.f;
      if (r == 0 && c == 0) val = (float)(n_act > ccap ? n_act - ccap : 0);
      if (r == 0 && c == 1) val = (float)n_act;
      if (r == 0 && c == 2) val = (float)dropped2;
      if (r == 0 && c == 3) val = (float)winovf;
      meta[(size_t)r * d.nb * kBlock + (size_t)b * kBlock + c] = val;
    }
  }
  if (!has_warm) return;

  // ---- phase 5: warm start by key match within the bucket ----
  // Slot j takes the λ of the first previous slot within 0.5 on both keys.
  // A current key is >= 0, or -2 in an empty slot; a previous one is >= 0,
  // or -1 when inactive. So an empty slot matches nothing, and no previous
  // slot from the last one keyed >= 0 on can match: each warp scans the
  // rest for its slots in turn, 128 previous slots a round by ballots.
  __syncthreads();   // *s.n_prev was zeroed at the start
  int last = 0;
  for (int i = tid; i < ccap; i += blockDim.x) {
    const float* pc = pcols + ((size_t)b * ccap + i) * 8;
    s.prev[i] = pc[0];
    s.prev[ccap + i] = pc[1];
    s.prev[2 * ccap + i] = pc[4];
    s.prev[3 * ccap + i] = pc[5];
    s.prev[4 * ccap + i] = pc[6];
    if (pc[0] > -0.5f) last = i + 1;
  }
  atomicMax(s.n_prev, last);
  __syncthreads();
  const int n_prev = *s.n_prev;
  const int lane = tid & 31;
  float* wout = warm + (size_t)b * ccap;
  for (int j0 = tid - lane; j0 < ccap; j0 += blockDim.x) {
    const int j = j0 + lane;
    const float my_ck = j < ccap ? s.ck[j] : -2.f;
    const float my_ch = j < ccap ? s.ch[j] : 0.f;
    int my_src = -1;
    for (int t = 0; t < 32; ++t) {
      const float ck = __shfl_sync(0xffffffffu, my_ck, t);
      const float ch = __shfl_sync(0xffffffffu, my_ch, t);
      int src = -1;
      for (int i0 = 0; ck >= 0.f && i0 < n_prev && src < 0; i0 += 128) {
        unsigned ballot[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int i = i0 + 32 * u + lane;
          const bool hit = i < n_prev && fabsf(s.prev[i] - ck) < 0.5f && fabsf(s.prev[ccap + i] - ch) < 0.5f;
          ballot[u] = __ballot_sync(0xffffffffu, hit);
        }
        // the lowest matching index: the serial scan's first match
#pragma unroll
        for (int u = 3; u >= 0; --u)
          if (ballot[u]) src = i0 + 32 * u + __ffs(ballot[u]) - 1;
      }
      if (lane == t) my_src = src;
    }
    if (j >= ccap) continue;
    wout[j] = my_src >= 0 ? s.prev[2 * ccap + my_src] : 0.f;
    wout[cp + j] = my_src >= 0 ? s.prev[3 * ccap + my_src] : 0.f;
    wout[2 * cp + j] = my_src >= 0 ? s.prev[4 * ccap + my_src] : 0.f;
#pragma unroll
    for (int k = 3; k < 8; ++k) wout[(size_t)k * cp + j] = 0.f;
  }
}

}  // namespace

// la/lb NULL with bp_k > 0 (the in-kernel broad phase); gate and prev_table
// NULL unless gated; pcols and warm NULL without warm start.
extern "C" int ct_bucket_contact_table(const float* geom, const int* la, const int* lb, const float* pcols,
                                       const int* gate, const float* prev_table, float* table, float* meta,
                                       float* warm, int nb, int bucket0, int cap, int cap2, int ccap, int kk, int kg,
                                       int npad, int rows, int bp_k, int env_k, float gh, void* stream) {
  if (kk > kCap || kg > 8 || rows > 32 || rows < 16 || (cap2 && cap2 > cap) || bucket0 < 0 || bp_k < 0 ||
      bp_k > kBlock || (!bp_k && (la == nullptr || lb == nullptr)) || (env_k && !bp_k) ||
      ((gate == nullptr) != (prev_table == nullptr)) || (size_t)(bucket0 + nb + 2) * kBlock > (size_t)npad)
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
  d.bp_k = bp_k;
  d.env_k = env_k;
  d.gh = gh;
  const size_t smem = carve(nullptr, d, pcols != nullptr).words * 4;
  int dev, limit;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  if (smem > (size_t)limit) return kSmemTooLarge;
  err = cudaFuncSetAttribute(contact_table_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  contact_table_kernel<<<nb, kThreads, smem, (cudaStream_t)stream>>>(geom, la, lb, pcols, gate, prev_table, table,
                                                                     meta, warm, d);
  return (int)cudaGetLastError();
}

// Text of a cudaError_t returned by any entry point of the library.
extern "C" const char* pk_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }
