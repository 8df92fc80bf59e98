// The generic banded branch's box contact list in one entry point (Hopper,
// sm_90a): the ground corners and the banded pair manifolds, written
// straight into the flat contact buffer.
//
// Replaces the TPU kernel pair_manifolds_banded
// (physics_tpu/ops/narrowphase_pallas.py:128, body _make_np_kernel :59-125)
// and the element-wise work around it. Plain version: banded_contacts_plain
// in physics_tpu_torch/ops/narrowphase.py, the composition of
// _ground_contacts_boxes, pair_operands, pair_manifolds_banded_plain, the
// slot-major reshaping and concat_contacts; the manifold is boxbox.cuh's,
// which the box contact table (contact_table.cu) shares, so with -fmad=false
// kernel and plain version agree bit for bit.
//
// Output columns: the ground slots [g0, g0 + g_count) of the slot-major
// ground list [k·N] (slot s·N + i: pick s of body i; slots ≥ k·N, the
// zero padding of a rank's slice, are zero), then kk·p_count pair slots
// (pick s of lane j at g_count + s·p_count + j). Rows: f32 [9, C] point
// xyz | normal xyz | depth | friction | restitution; int32 [5, C]
// body_a | body_b | key | lo (rank of body_a) | rank_b; bool [C] active.
//
// Two kernels on the caller's stream:
//   ground (one thread per ground slot): the body's rotation from its
//     quaternion (vec3c.quat_to_mat's order), its 8 corners, the
//     depths below y = ground_height (−inf for a static or non-box
//     body), s + 1 argmax picks (first index on ties); key −(i·8 + corner
//     + 1) when active;
//   pairs (one thread per candidate lane of this rank's slice, lanes
//     j0 + j of the unpadded candidate arrays; beyond them zero lanes):
//     the tile's window base (the static bucket-derived bases, or in
//     chunked mode the tile's lowest live rank rounded down to 128, a
//     block-wide min over the tile), the window-local endpoints
//     (pair_operands), and for a live lane the 15-axis manifold and its kk
//     deepest valid points; an empty or out-of-band lane writes the rows
//     the plain version computes for two zero bodies without running the
//     manifold. Ids from the body table's rows below 2¹⁶ bodies (else the
//     candidates'), key (min id·n + max id)·8 + slot while n²·8 fits int32.
// What bounds it on the H100: ~3.5k dependent f32 operations a live lane
// against ~60 loaded floats, so latency and occupancy; only ~1 in 5 of the
// 4k pile's 32,768 lanes is live, and the empty ones now exit after their
// stores. The element-wise glue this replaces was ~700 launches a step.

#include <math_constants.h>

#include "boxbox.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kGeomRow0 = 24;    // narrow-phase block of the unified table
constexpr int kShapeBox = 2;     // state.SHAPE_BOX
constexpr int kFlagChunked = 1;  // window bases from each tile's lanes
constexpr int kFlagIdsFromRows = 2;
constexpr int kFlagKeys = 4;

struct Out {
  float* f;                // [9, C]
  int* i;                  // [5, C]
  unsigned char* active;   // [C]
  int c;                   // C
};

__device__ __forceinline__ void put(const Out& o, int col, V3 pt, V3 nrm, float depth, float fric, float rest,
                                    int ia, int ib, int key, int lo, int rb, bool act) {
  const size_t C = (size_t)o.c;
  float* f = o.f + col;
  f[0] = pt.x;
  f[C] = pt.y;
  f[2 * C] = pt.z;
  f[3 * C] = nrm.x;
  f[4 * C] = nrm.y;
  f[5 * C] = nrm.z;
  f[6 * C] = depth;
  f[7 * C] = fric;
  f[8 * C] = rest;
  int* i = o.i + col;
  i[0] = ia;
  i[C] = ib;
  i[2 * C] = key;
  i[3 * C] = lo;
  i[4 * C] = rb;
  o.active[col] = act ? 1 : 0;
}

__global__ void __launch_bounds__(kThreads)
ground_corners_kernel(const float* __restrict__ pos, const float* __restrict__ quat,
                      const float* __restrict__ params, const float* __restrict__ inv_mass,
                      const int* __restrict__ stype, const float* __restrict__ fric,
                      const float* __restrict__ rest, const int* __restrict__ rank, Out o, int n, int kg,
                      int g0, int g_count, float gh) {
  const int gl = blockIdx.x * blockDim.x + threadIdx.x;
  if (gl >= g_count) return;
  const int g = g0 + gl;
  const V3 zero = mk(0.f, 0.f, 0.f);
  if (g >= kg * n) {   // the zero padding of a rank's slice
    put(o, gl, zero, zero, 0.f, 0.f, 0.f, 0, 0, 0, 0, 0, false);
    return;
  }
  const int s = g / n, b = g - s * n;
  const float w = quat[4 * b], x = quat[4 * b + 1], y = quat[4 * b + 2], z = quat[4 * b + 3];
  const float ww = w * w, xx = x * x, yy = y * y, zz = z * z;
  const float xy = x * y * 2.0f, wz = w * z * 2.0f, wy = w * y * 2.0f;
  const float xz = x * z * 2.0f, yz = y * z * 2.0f, wx = w * x * 2.0f;
  const float r[9] = {ww + xx - yy - zz, xy - wz, wy + xz,
                      wz + xy, ww - xx + yy - zz, yz - wx,
                      xz - wy, wx + yz, ww - xx - yy + zz};
  const float hx = params[3 * b], hy = params[3 * b + 1], hz = params[3 * b + 2];
  const V3 p = mk(pos[3 * b], pos[3 * b + 1], pos[3 * b + 2]);
  const bool valid_base = (inv_mass[b] > 0.f) && (stype[b] == kShapeBox);
  V3 pts[8];
  float score[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {   // signs (sx, sy, sz) with sz fastest
    const float sx = (k & 4) ? 1.f : -1.f, sy = (k & 2) ? 1.f : -1.f, sz = (k & 1) ? 1.f : -1.f;
    const float cx0 = sx * hx, cy0 = sy * hy, cz0 = sz * hz;
    pts[k] = mk(p.x + r[0] * cx0 + r[1] * cy0 + r[2] * cz0, p.y + r[3] * cx0 + r[4] * cy0 + r[5] * cz0,
                p.z + r[6] * cx0 + r[7] * cy0 + r[8] * cz0);
    const float d = gh - pts[k].y;
    score[k] = (valid_base && (d > 0.f)) ? d : -CUDART_INF_F;
  }
  float best = 0.f;
  int bidx = 0;
  for (int pick = 0; pick <= s; ++pick) {
    argmax(score, best, bidx);
#pragma unroll
    for (int k = 0; k < 8; ++k) score[k] = bidx == k ? -CUDART_INF_F : score[k];
  }
  const bool act = isfinite(best) && (best > 0.f);
  put(o, gl, select(bidx, pts), mk(0.f, 1.f, 0.f), act ? best : 0.f, fric[b], rest[b], b, -1,
      act ? -(b * 8 + bidx + 1) : 0, rank[b], -1, act);
}

struct Lanes {
  const unsigned char* mask;
  const int *rank_a, *rank_b, *body_a, *body_b;
  int p_total;   // unpadded candidate lanes
  int j0;        // this rank's first lane
};

__device__ __forceinline__ bool lane_live(const Lanes& c, int j, int p_count) {
  const int g = c.j0 + j;
  return j < p_count && g < c.p_total && c.mask[g];
}

__global__ void __launch_bounds__(kThreads)
pair_contacts_kernel(const float* __restrict__ geom_all, const int* __restrict__ bases, Lanes c, Out o,
                     int g_count, int p_count, int tile, int npad, int wtot, int kk, int n, int flags) {
  __shared__ int warp_min[kThreads / 32];
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int t = (blockIdx.x * blockDim.x) / tile;   // a block lies in one tile
  int base;
  if (flags & kFlagChunked) {
    int m = npad - 1;
    for (int i = threadIdx.x; i < tile; i += blockDim.x) {
      const int l = t * tile + i;
      if (lane_live(c, l, p_count)) m = min(m, c.rank_a[c.j0 + l]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m = min(m, __shfl_xor_sync(0xffffffffu, m, off));
    if ((threadIdx.x & 31) == 0) warp_min[threadIdx.x >> 5] = m;
    __syncthreads();
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) m = min(m, warp_min[w]);
    base = min(max(m / 128 * 128, 0), npad - wtot);
  } else {
    base = bases[j / tile];
  }
  if (j >= p_count) return;
  const int g = c.j0 + j;
  const bool in = g < c.p_total;
  const bool m = in && c.mask[g];
  const int ra = in ? c.rank_a[g] : 0, rbk = in ? c.rank_b[g] : 0;
  const int la = ra - base, lb = rbk - base;
  const bool ok = m && la >= 0 && la < wtot && lb >= 0 && lb < wtot;
  const int col0 = g_count + j;
  const size_t P = (size_t)p_count;

  int ia = 0, ib = 0;
  if (!(flags & kFlagIdsFromRows)) {
    ia = in ? c.body_a[g] : 0;
    ib = in ? c.body_b[g] : 0;
  }
  if (!ok) {
    // two zero bodies: no valid slot, points 0, the manifold's normal −0
    const V3 zero = mk(0.f, 0.f, 0.f), nz = mk(-0.f, -0.f, -0.f);
    for (int s = 0; s < kk; ++s) put(o, col0 + s * (int)P, zero, nz, 0.f, 0.f, 0.f, ia, ib, 0, ra, rbk, false);
    return;
  }
  const float* geom = geom_all + (size_t)kGeomRow0 * npad;
  const Box A = load_box(geom, npad, base + la);
  const Box B = load_box(geom, npad, base + lb);
  if (flags & kFlagIdsFromRows) {
    ia = (int)A.id;
    ib = (int)B.id;
  }
  V3 pts[kCap];
  float depth[kCap];
  bool valid[kCap];
  V3 nrm;
  box_box_manifold(A, B, pts, depth, valid, nrm);
  const bool movable = (A.movable > 0.f) || (B.movable > 0.f);
  float score[kCap];
#pragma unroll
  for (int k = 0; k < kCap; ++k) score[k] = (valid[k] && movable) ? depth[k] : kBigNeg;
  const int base_key = (flags & kFlagKeys) ? (min(ia, ib) * n + max(ia, ib)) * kCap : 0;
  const float fr = sqrtf(A.fric * B.fric), re = fmaxf(A.rest, B.rest);
  for (int pick = 0; pick < kk; ++pick) {
    float best;
    int bidx;
    argmax(score, best, bidx);
    const bool act = best > 0.f;
    const int key = (act && (flags & kFlagKeys)) ? base_key + bidx : 0;
    put(o, col0 + pick * (int)P, select(bidx, pts), nrm, act ? best : 0.f, fr, re, ia, ib, key, ra, rbk, act);
#pragma unroll
    for (int k = 0; k < kCap; ++k) score[k] = bidx == k ? kBigNeg : score[k];
  }
}

}  // namespace

extern "C" int np_banded_contacts(const float* pos, const float* quat, const float* params, const float* inv_mass,
                                  const int* stype, const float* fric, const float* rest, const int* rank,
                                  const float* geom, const int* bases, const unsigned char* mask,
                                  const int* rank_a, const int* rank_b, const int* body_a, const int* body_b,
                                  float* fout, int* iout, unsigned char* active, int n, int kg, int g0,
                                  int g_count, float gh, int p_total, int j0, int p_count, int tile, int npad,
                                  int wtot, int kk, int flags, void* stream) {
  if (kg < 0 || kg > 8 || g_count < 0 || p_count < 0 || (p_count && (kk < 1 || kk > kCap || tile < 1)) ||
      ((flags & kFlagChunked) && tile % kThreads) || (!(flags & kFlagChunked) && p_count && !bases))
    return (int)cudaErrorInvalidValue;
  Out o;
  o.f = fout;
  o.i = iout;
  o.active = active;
  o.c = g_count + kk * p_count;
  cudaStream_t st = (cudaStream_t)stream;
  if (g_count)
    ground_corners_kernel<<<(g_count + kThreads - 1) / kThreads, kThreads, 0, st>>>(
        pos, quat, params, inv_mass, stype, fric, rest, rank, o, n, kg, g0, g_count, gh);
  if (p_count) {
    Lanes c;
    c.mask = mask;
    c.rank_a = rank_a;
    c.rank_b = rank_b;
    c.body_a = body_a;
    c.body_b = body_b;
    c.p_total = p_total;
    c.j0 = j0;
    pair_contacts_kernel<<<(p_count + kThreads - 1) / kThreads, kThreads, 0, st>>>(
        geom, bases, c, o, g_count, p_count, tile, npad, wtot, kk, n, flags);
  }
  return (int)cudaGetLastError();
}
