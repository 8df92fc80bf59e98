// The generic hull path's pair contacts of one hull type-pair segment in two
// launches: the CUDA version of physics_tpu_torch/ops/hull_list.py
// hull_pair_contacts (plain version: ops/narrowphase.py
// _pair_contacts_hulls_fast, which runs ops/hullhull_batched.py
// shared_hull_manifolds_sm and the kk slot picks a segment). Not a TPU
// kernel: the JAX package leaves these manifolds to XLA's glue
// (physics_tpu/ops/hullhull_batched.py shared_hull_manifolds_sm,
// physics_tpu/ops/narrowphase.py _hull_fast_select_rows). Built from PyTorch
// operations a segment took ~1,840 launches a step at the 1,024-hull rain,
// each ~1.4 µs on the card whatever the lane count.
//
// Launch A, list_sat_kernel: a block a (tile of 128 lanes, split of the
// SAT's items); a thread a lane. The items are the 2F faces (A's, then B's)
// and the D² edge axes of the type pair's coefficient tables; a split's rows
// are staged in shared memory at a 12-float stride and read as warp-wide
// broadcasts, while each thread keeps its lane's relative rotation M = R_aᵀR_b
// and the offsets dpa, dpb in registers. It writes every item's separation to
// the scratch sep [2F + D², P]: a face's min over its vertex rows plus its
// normal's offset, an axis's the projected gap over the axis length (with the
// flip, the length guard and the axis mask), −1e30 where masked.
//
// Launch B, list_picks_kernel: eight threads a lane (one thread a lane left
// 128 warps on 132 SMs, latency-bound at 61.7 µs; eight took 22.6 at the
// 1,024-hull rain on an H100). It takes the best face and the best axis
// from sep in index order (ties to the lowest), decides separated
// and edge_wins, picks the incident face by the least alignment with the
// reference face, clips its world polygon against the reference face's
// ref_cnt edges (Sutherland–Hodgman, as boxbox_batched._clip: emission order,
// drops past 2E, +0.0 on every emitted value), finds the edge pair by support
// along the best axis and its clamped closest points, folds validity into the
// S = 2E + 1 slot depths, and makes the kk argmax picks (ties to the lowest
// slot), writing each straight into the segment's slot-major Contacts rows:
// row k·stride + lane0 + j of body_a, body_b, point, normal, depth, active,
// friction √(μ_a μ_b), restitution max, key (min·n + max)·S + slot (0 without
// keys or when inactive). Masked and separated lanes run the same path.
//
// Bound: operations. A lane's SAT is ≈5,380 9-term dots at the rain's
// library (F 26, V 24, D² 81): ≈91 k f32 operations, ≈0.37 G for 4,096 lanes,
// 5.6 µs at 67 TFLOP/s; the tables (≈194 KB) are read once a block split, the
// rows out ≈0.7 MB.
//
// Bit for bit with the plain version, built with -fmad=false: every
// element-wise expression is spelled in the plain version's order, and each
// product that the plain version takes from a library sums in the order it
// takes on the card (measured on an H100 against the plain version's
// operands): a [rows, 3] × [3, P] matmul (cuBLAS SGEMM) as one fused
// multiply-add chain over k ascending from 0 (gemm3); a [rows, 9] × [9, P]
// one as that chain or, at some shapes (the wrapper's `orders`, asked of
// cuBLAS once a shape), as chains over k 0–3, 4–7 and 8 added in turn
// (gemm9 and smem_dot9's split4); torch.sum over the middle dimension of a [R, K, P] tensor as
// PyTorch's reduction deals it to one thread's four accumulators, acc[k mod 4],
// each from 0, combined as ((acc0 + acc1) + acc2) + acc3 (tsum9, tsum3).
// One-hot products select exactly; min, max and argmax/argmin (first index)
// are exact in any order.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kBig = 1e30f;
constexpr int kSatLanes = 128;       // lanes of a SAT block, one a thread
constexpr int kFacesPerSplit = 4;    // face items of a SAT split
constexpr int kAxesPerSplit = 3;     // axis items of a SAT split
constexpr int kRow = 12;             // shared-memory stride of a 9-float row
constexpr int kPickThreads = 128;    // a picks block: 16 lanes of kGroup threads
constexpr int kGroup = 8;
constexpr int kShapeHull = 3;        // state.SHAPE_HULL

struct Dims {
  int f, v, d2, e, e2;
};

// the type pair's tables (ops/hull_list.py _pack: HullTables' fields, flat)
struct Tables {
  const float *a_fv, *b_fv, *c_av, *c_bv, *l_ax, *ff;
  const float *n_a, *n_b, *off_a, *off_b, *fmask_a, *fmask_b, *ax_mask;
  const float *verts_a, *verts_b, *emask_a, *emask_b;
  const int *fv_a, *fv_b, *fcnt_a, *fcnt_b, *i0a, *i1a, *i0b, *i1b;
};

__host__ __device__ inline long long ftab_floats(const Dims& d) {
  return 2LL * d.f * d.v * 9 + 2LL * d.d2 * d.v * 9 + d.d2 * 27LL + 9LL * d.f * d.f + 10LL * d.f + d.d2 +
         6LL * d.v + 2LL * d.e2;
}

__host__ __device__ inline long long itab_ints(const Dims& d) { return 2LL * d.f * d.e + 2LL * d.f + 4LL * d.e2; }

__device__ inline Tables tables(const float* ft, const int* it, const Dims& d) {
  Tables t;
  const float* q = ft;
  t.a_fv = q; q += d.f * d.v * 9;
  t.b_fv = q; q += d.f * d.v * 9;
  t.c_av = q; q += d.d2 * d.v * 9;
  t.c_bv = q; q += d.d2 * d.v * 9;
  t.l_ax = q; q += d.d2 * 27;
  t.ff = q; q += d.f * d.f * 9;
  t.n_a = q; q += d.f * 3;
  t.n_b = q; q += d.f * 3;
  t.off_a = q; q += d.f;
  t.off_b = q; q += d.f;
  t.fmask_a = q; q += d.f;
  t.fmask_b = q; q += d.f;
  t.ax_mask = q; q += d.d2;
  t.verts_a = q; q += d.v * 3;
  t.verts_b = q; q += d.v * 3;
  t.emask_a = q; q += d.e2;
  t.emask_b = q;
  const int* r = it;
  t.fv_a = r; r += d.f * d.e;
  t.fv_b = r; r += d.f * d.e;
  t.fcnt_a = r; r += d.f;
  t.fcnt_b = r; r += d.f;
  t.i0a = r; r += d.e2;
  t.i1a = r; r += d.e2;
  t.i0b = r; r += d.e2;
  t.i1b = r;
  return t;
}

struct Args {
  const float* pos;          // [N, 3]
  const float* quat;         // [N, 4] (w, x, y, z)
  const float* inv_mass;     // [N]
  const int* stype;          // [N]
  const float* friction;     // [N]
  const float* restitution;  // [N]
  const int* body_a;         // [P_tot] candidates (the segment: lane0 + j)
  const int* body_b;
  const bool* mask;
  const float* ftab;
  const int* itab;
  float* sep;                // [2F + D², p] scratch
  float* point;              // [3, C] out, C = kk·stride
  float* normal;             // [3, C]
  float* depth;              // [C]
  bool* active;              // [C]
  float* fric_out;           // [C]
  float* rest_out;           // [C]
  int* key;                  // [C]
  int* ia_out;               // [C]
  int* ib_out;               // [C]
  unsigned long long* sink;  // [2] SAT lanes, overlaps (or NULL)
  Dims d;
  int n, lane0, p, stride, kk, has_key;
  int orders;  // split4 of the face (1), axis-vertex (2) and axis (4) tables
};

constexpr int kSplitFaces = 1, kSplitAxisVerts = 2, kSplitAxes = 4;

// ---- the plain version's products, in the card's sum orders ----

// a row of a [rows, 9] table times M, as cuBLAS's SGEMM sums it: one fused
// multiply-add chain over k, or (split4) chains over k 0–3, 4–7 and 8
// added in turn
__device__ __forceinline__ float gemm9(const float* a, const float m[9], bool split4) {
  if (split4) {
    float c0 = 0.0f, c1 = 0.0f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      c0 = __fmaf_rn(a[k], m[k], c0);
      c1 = __fmaf_rn(a[4 + k], m[4 + k], c1);
    }
    return (c0 + c1) + __fmaf_rn(a[8], m[8], 0.0f);
  }
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < 9; ++k) acc = __fmaf_rn(a[k], m[k], acc);
  return acc;
}

__device__ __forceinline__ float gemm3(const float* a, const float x[3]) {
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < 3; ++k) acc = __fmaf_rn(a[k], x[k], acc);
  return acc;
}

// torch.sum over the middle dimension of [R, 9, P] products a[k]·m[k]
__device__ __forceinline__ float tsum9(const float* a, const float m[9]) {
  float t[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) t[k] = a[k] * m[k];
  const float acc0 = ((0.0f + t[0]) + t[4]) + t[8];
  const float acc1 = (0.0f + t[1]) + t[5];
  const float acc2 = (0.0f + t[2]) + t[6];
  const float acc3 = (0.0f + t[3]) + t[7];
  return ((acc0 + acc1) + acc2) + acc3;
}

// torch.sum over the middle dimension of [R, 3, P]
__device__ __forceinline__ float tsum3(float t0, float t1, float t2) {
  return (((0.0f + t0) + (0.0f + t1)) + (0.0f + t2)) + 0.0f;
}

// torch.amin / amax / maximum / minimum: a NaN carries through
__device__ __forceinline__ float min_nan(float a, float b) { return (a < b || a != a) ? a : b; }
__device__ __forceinline__ float max_nan(float a, float b) { return (a > b || a != a) ? a : b; }
__device__ __forceinline__ float clamp_min(float x, float lo) { return x < lo ? lo : x; }
__device__ __forceinline__ float clamp01(float x) { return min_nan(max_nan(x, 0.0f), 1.0f); }

__device__ __forceinline__ void quat_to_mat(const float q[4], float r[9]) {
  const float w = q[0], x = q[1], y = q[2], z = q[3];
  const float ww = w * w, xx = x * x, yy = y * y, zz = z * z;
  const float xy = x * y * 2.0f, wz = w * z * 2.0f, wy = w * y * 2.0f;
  const float xz = x * z * 2.0f, yz = y * z * 2.0f, wx = w * x * 2.0f;
  r[0] = ww + xx - yy - zz;
  r[1] = xy - wz;
  r[2] = wy + xz;
  r[3] = wz + xy;
  r[4] = ww - xx + yy - zz;
  r[5] = yz - wx;
  r[6] = xz - wy;
  r[7] = wx + yz;
  r[8] = ww - xx - yy + zz;
}

__device__ __forceinline__ void mat_vec(const float r[9], const float v[3], float out[3]) {
  out[0] = r[0] * v[0] + r[1] * v[1] + r[2] * v[2];
  out[1] = r[3] * v[0] + r[4] * v[1] + r[5] * v[2];
  out[2] = r[6] * v[0] + r[7] * v[1] + r[8] * v[2];
}

__device__ __forceinline__ float dot3(const float a[3], const float b[3]) { return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]; }

// a lane's poses: M = R_aᵀR_b (from q_a* ⊗ q_b), R_a, R_b, p_a, p_b,
// dpa = R_aᵀ(p_b − p_a), dpb = R_bᵀ(p_a − p_b)
struct Pose {
  float m[9], ra[9], rb[9], pa[3], pb[3], dpa[3], dpb[3];
};

__device__ __forceinline__ void lane_pose(const Args& p, int ia, int ib, Pose& s) {
  float qa[4], qb[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    qa[c] = p.quat[4 * (size_t)ia + c];
    qb[c] = p.quat[4 * (size_t)ib + c];
  }
  const float w1 = qa[0], x1 = -qa[1], y1 = -qa[2], z1 = -qa[3];
  const float w2 = qb[0], x2 = qb[1], y2 = qb[2], z2 = qb[3];
  const float rel[4] = {w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2, w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2, w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2};
  quat_to_mat(rel, s.m);
  quat_to_mat(qa, s.ra);
  quat_to_mat(qb, s.rb);
  float dp[3], ndp[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    s.pa[c] = p.pos[3 * (size_t)ia + c];
    s.pb[c] = p.pos[3 * (size_t)ib + c];
    dp[c] = s.pb[c] - s.pa[c];
    ndp[c] = -dp[c];
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    s.dpa[i] = s.ra[i] * dp[0] + s.ra[3 + i] * dp[1] + s.ra[6 + i] * dp[2];
    s.dpb[i] = s.rb[i] * ndp[0] + s.rb[3 + i] * ndp[1] + s.rb[6 + i] * ndp[2];
  }
}

// an edge axis's length (guarded) and t_ax = ax·(p_a − p_b) in A's frame;
// the axis flips where t_ax < 0
__device__ __forceinline__ void axis_terms(const float ax[3], const Pose& s, float& alen, float& t_ax) {
  alen = sqrtf(clamp_min(tsum3(ax[0] * ax[0], ax[1] * ax[1], ax[2] * ax[2]), 1e-18f));
  t_ax = -tsum3(ax[0] * s.dpa[0], ax[1] * s.dpa[1], ax[2] * s.dpa[2]);
}

// ---- launch A: the SAT ----

// gemm9 of a row staged in shared memory (16-byte aligned)
__device__ __forceinline__ float smem_dot9(const float* row, const float m[9], bool split4) {
  const float4 a = *reinterpret_cast<const float4*>(row);
  const float4 b = *reinterpret_cast<const float4*>(row + 4);
  float c0 = 0.0f;
  c0 = __fmaf_rn(a.x, m[0], c0);
  c0 = __fmaf_rn(a.y, m[1], c0);
  c0 = __fmaf_rn(a.z, m[2], c0);
  c0 = __fmaf_rn(a.w, m[3], c0);
  if (split4) {
    float c1 = 0.0f;
    c1 = __fmaf_rn(b.x, m[4], c1);
    c1 = __fmaf_rn(b.y, m[5], c1);
    c1 = __fmaf_rn(b.z, m[6], c1);
    c1 = __fmaf_rn(b.w, m[7], c1);
    return (c0 + c1) + __fmaf_rn(row[8], m[8], 0.0f);
  }
  c0 = __fmaf_rn(b.x, m[4], c0);
  c0 = __fmaf_rn(b.y, m[5], c0);
  c0 = __fmaf_rn(b.z, m[6], c0);
  c0 = __fmaf_rn(b.w, m[7], c0);
  return __fmaf_rn(row[8], m[8], c0);
}

__device__ __forceinline__ void stage_rows(float* dst, const float* src, int rows) {
  for (int i = threadIdx.x; i < rows * 9; i += blockDim.x) dst[(i / 9) * kRow + i % 9] = src[i];
}

__global__ void __launch_bounds__(kSatLanes) list_sat_kernel(Args p, int face_splits) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const Dims d = p.d;
  const Tables t = tables(p.ftab, p.itab, d);
  const int split = blockIdx.y;
  const bool faces = split < face_splits;
  const int i0 = faces ? split * kFacesPerSplit : (split - face_splits) * kAxesPerSplit;
  const int i1 = faces ? min(2 * d.f, i0 + kFacesPerSplit) : min(d.d2, i0 + kAxesPerSplit);
  const int axis_rows = 2 * d.v + 3;  // A's vertices, B's vertices, the axis
  for (int i = i0; i < i1; ++i) {
    if (faces) {
      const float* src = i < d.f ? t.a_fv + (size_t)i * d.v * 9 : t.b_fv + (size_t)(i - d.f) * d.v * 9;
      stage_rows(sm + (size_t)(i - i0) * d.v * kRow, src, d.v);
    } else {
      float* dst = sm + (size_t)(i - i0) * axis_rows * kRow;
      stage_rows(dst, t.c_av + (size_t)i * d.v * 9, d.v);
      stage_rows(dst + d.v * kRow, t.c_bv + (size_t)i * d.v * 9, d.v);
      stage_rows(dst + 2 * d.v * kRow, t.l_ax + (size_t)i * 27, 3);
    }
  }
  __syncthreads();
  const int j = blockIdx.x * kSatLanes + threadIdx.x;
  if (j >= p.p) return;
  const int l = p.lane0 + j;
  Pose s;
  lane_pose(p, p.body_a[l], p.body_b[l], s);
  const bool split_f = (p.orders & kSplitFaces) != 0, split_v = (p.orders & kSplitAxisVerts) != 0,
             split_x = (p.orders & kSplitAxes) != 0;
  for (int i = i0; i < i1; ++i) {
    float sep;
    if (faces) {
      const float* rows = sm + (size_t)(i - i0) * d.v * kRow;
      float mn = smem_dot9(rows, s.m, split_f);
      for (int v = 1; v < d.v; ++v) mn = min_nan(mn, smem_dot9(rows + v * kRow, s.m, split_f));
      const bool on_a = i < d.f;
      const int f = on_a ? i : i - d.f;
      const float nd = gemm3((on_a ? t.n_a : t.n_b) + 3 * f, on_a ? s.dpa : s.dpb);
      sep = (mn + nd) - (on_a ? t.off_a : t.off_b)[f];
      if (!((on_a ? t.fmask_a : t.fmask_b)[f] > 0.0f)) sep = -kBig;
    } else {
      const float* rows = sm + (size_t)(i - i0) * axis_rows * kRow;
      float mna = smem_dot9(rows, s.m, split_v), mxa = mna;
      for (int v = 1; v < d.v; ++v) {
        const float x = smem_dot9(rows + v * kRow, s.m, split_v);
        mna = min_nan(mna, x);
        mxa = max_nan(mxa, x);
      }
      const float* rb = rows + d.v * kRow;
      float mnb = smem_dot9(rb, s.m, split_v), mxb = mnb;
      for (int v = 1; v < d.v; ++v) {
        const float x = smem_dot9(rb + v * kRow, s.m, split_v);
        mnb = min_nan(mnb, x);
        mxb = max_nan(mxb, x);
      }
      const float* ra = rows + 2 * d.v * kRow;
      float ax[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) ax[c] = smem_dot9(ra + c * kRow, s.m, split_x);
      float alen, t_ax;
      axis_terms(ax, s, alen, t_ax);
      const float num = t_ax < 0.0f ? (mnb - mxa) - t_ax : (mna - mxb) + t_ax;
      const bool ok = t.ax_mask[i] > 0.0f && alen > 1e-6f;
      sep = ok ? num / alen : -kBig;
    }
    const int item = faces ? i : 2 * d.f + i;
    p.sep[(size_t)item * p.p + j] = sep;
  }
}

// ---- launch B: the manifold and the picks ----

// polygon slot q of a [CAPMAX] array: static indices (registers) up to 16
template <int CAPMAX>
__device__ __forceinline__ float get_slot(const float* a, int q) {
  if constexpr (CAPMAX <= 16) {
    float v = 0.0f;
#pragma unroll
    for (int k = 0; k < CAPMAX; ++k)
      if (k == q) v = a[k];
    return v;
  } else {
    return a[q];
  }
}

template <int CAPMAX>
__device__ __forceinline__ void put_slot(float* a, int q, float v) {
  if constexpr (CAPMAX <= 16) {
#pragma unroll
    for (int k = 0; k < CAPMAX; ++k)
      if (k == q) a[k] = v;
  } else {
    a[q] = v;
  }
}

// one Sutherland–Hodgman half-plane clip of the polygon's first cap slots
// (keep cu·u + cv·v ≤ d)
template <int CAPMAX>
__device__ void clip(float* pu, float* pv, float* ps, int& m, int cap, float cu, float cv, float d) {
  constexpr int kUnroll = CAPMAX <= 16 ? CAPMAX : 1;
  float g[CAPMAX], ou[CAPMAX], ov[CAPMAX], os[CAPMAX];
#pragma unroll
  for (int i = 0; i < CAPMAX; ++i) {
    g[i] = cu * pu[i] + cv * pv[i] - d;
    ou[i] = ov[i] = os[i] = 0.0f;
  }
  int start = 0;
#pragma unroll kUnroll
  for (int i = 0; i < CAPMAX; ++i) {
    if (i < cap) {
      const bool live = i < m;
      const int nx = (i + 1 == m || i + 1 == cap || i + 1 == CAPMAX) ? 0 : i + 1;
      const bool in_now = g[i] <= 0.0f, in_next = g[nx] <= 0.0f;
      const bool inside = in_now && live;
      const bool crossing = (in_now != in_next) && live;
      if (inside && start < cap) {
        put_slot<CAPMAX>(ou, start, pu[i] + 0.0f);
        put_slot<CAPMAX>(ov, start, pv[i] + 0.0f);
        put_slot<CAPMAX>(os, start, ps[i] + 0.0f);
      }
      const int q = start + (inside ? 1 : 0);
      if (crossing && q < cap) {
        const float den = g[i] - g[nx];
        const float tt = fabsf(den) > 1e-12f ? g[i] / den : 0.0f;
        put_slot<CAPMAX>(ou, q, (pu[i] + tt * (pu[nx] - pu[i])) + 0.0f);
        put_slot<CAPMAX>(ov, q, (pv[i] + tt * (pv[nx] - pv[i])) + 0.0f);
        put_slot<CAPMAX>(os, q, (ps[i] + tt * (ps[nx] - ps[i])) + 0.0f);
      }
      start += (inside ? 1 : 0) + (crossing ? 1 : 0);
    }
  }
#pragma unroll
  for (int i = 0; i < CAPMAX; ++i) {
    pu[i] = ou[i];
    pv[i] = ov[i];
    ps[i] = os[i];
  }
  m = min(start, cap);
}

// a world vertex: R·(the owner's vertex k) + t
__device__ __forceinline__ void world_vert(const float* verts, int k, const float r[9], const float tr[3],
                                           float out[3]) {
  const float* l = verts + 3 * k;
  out[0] = r[0] * l[0] + r[1] * l[1] + r[2] * l[2] + tr[0];
  out[1] = r[3] * l[0] + r[4] * l[1] + r[5] * l[2] + tr[1];
  out[2] = r[6] * l[0] + r[7] * l[1] + r[8] * l[2] + tr[2];
}

// the group's (a lane's kGroup threads') best: the larger value (argmax) or
// the smaller (argmin), ties to the lower index; an empty share is index
// kNone, which any other loses to
constexpr int kNone = 0x7fffffff;

__device__ __forceinline__ void group_argmax(float& v, int& i) {
#pragma unroll
  for (int off = kGroup / 2; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    if (oi != kNone && (i == kNone || ov > v || (ov == v && oi < i))) {
      v = ov;
      i = oi;
    }
  }
}

__device__ __forceinline__ void group_argmin(float& v, int& i) {
#pragma unroll
  for (int off = kGroup / 2; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    if (oi != kNone && (i == kNone || ov < v || (ov == v && oi < i))) {
      v = ov;
      i = oi;
    }
  }
}

// kGroup threads a lane: each takes every kGroup-th item of the searches
// (the SAT's choices, the incident face, the edge pair), the group combines
// them by shuffles, and every thread of the group then runs the clip and the
// picks alike; thread r writes the picks k ≡ r (mod kGroup)
template <int CAPMAX>
__global__ void __launch_bounds__(kPickThreads) list_picks_kernel(Args p) {
  const Dims d = p.d;
  const Tables t = tables(p.ftab, p.itab, d);
  const int r = threadIdx.x % kGroup;
  const int j_raw = blockIdx.x * (kPickThreads / kGroup) + threadIdx.x / kGroup;
  const bool valid = j_raw < p.p;  // the rest mirror the last lane for the shuffles
  const int j = valid ? j_raw : p.p - 1;
  const int l = p.lane0 + j;
  const int ia = p.body_a[l], ib = p.body_b[l];
  const bool lane_on = p.mask[l];
  Pose s;
  lane_pose(p, ia, ib, s);

  // ---- the SAT's choices ----
  float face_sep = 0.0f, edge_sep = 0.0f;
  int best_f = kNone, best_e = kNone;
  for (int f = r; f < 2 * d.f; f += kGroup) {
    const float x = p.sep[(size_t)f * p.p + j];
    if (best_f == kNone || x > face_sep) {
      face_sep = x;
      best_f = f;
    }
  }
  const float* sep_e = p.sep + (size_t)2 * d.f * p.p;
  for (int x = r; x < d.d2; x += kGroup) {
    const float y = sep_e[(size_t)x * p.p + j];
    if (best_e == kNone || y > edge_sep) {
      edge_sep = y;
      best_e = x;
    }
  }
  group_argmax(face_sep, best_f);
  group_argmax(edge_sep, best_e);
  const bool separated = max_nan(face_sep, edge_sep) > 0.0f;
  const bool edge_wins = !separated && edge_sep > face_sep + 1e-4f + 0.05f * fabsf(face_sep);
  if (p.sink != nullptr) {
    const bool me = valid && r == 0 && lane_on;
    const unsigned on = __ballot_sync(0xffffffffu, me);
    const unsigned pass = __ballot_sync(0xffffffffu, me && !separated);
    if ((threadIdx.x & 31) == 0) {
      if (on) atomicAdd(p.sink, (unsigned long long)__popc(on));
      if (pass) atomicAdd(p.sink + 1, (unsigned long long)__popc(pass));
    }
  }

  // ---- reference and incident faces ----
  const bool ref_is_a = best_f < d.f;
  const int ref = ref_is_a ? best_f : best_f - d.f;
  int inc = kNone;
  float best_al = 0.0f;
  for (int o = r; o < d.f; o += kGroup) {
    const float* row = t.ff + 9 * (size_t)(ref_is_a ? ref * d.f + o : o * d.f + ref);
    const float pad = ((ref_is_a ? t.fmask_b : t.fmask_a)[o] > 0.0f) ? 0.0f : kBig;
    const float al = tsum9(row, s.m) + pad;
    if (inc == kNone || al < best_al) {
      best_al = al;
      inc = o;
    }
  }
  group_argmin(best_al, inc);
  const float* r_ref = ref_is_a ? s.ra : s.rb;
  const float* r_inc = ref_is_a ? s.rb : s.ra;
  const float* p_ref = ref_is_a ? s.pa : s.pb;
  const float* p_inc = ref_is_a ? s.pb : s.pa;
  const float* v_ref = ref_is_a ? t.verts_a : t.verts_b;
  const float* v_inc = ref_is_a ? t.verts_b : t.verts_a;
  const int* fv_ref = (ref_is_a ? t.fv_a : t.fv_b) + (size_t)ref * d.e;
  const int* fv_inc = (ref_is_a ? t.fv_b : t.fv_a) + (size_t)inc * d.e;
  const int ref_cnt = (ref_is_a ? t.fcnt_a : t.fcnt_b)[ref];
  const int inc_cnt = (ref_is_a ? t.fcnt_b : t.fcnt_a)[inc];
  const float* n_loc = (ref_is_a ? t.n_a : t.n_b) + 3 * ref;
  float n_ref[3];
  mat_vec(r_ref, n_loc, n_ref);
  const float off_ref = (ref_is_a ? t.off_a : t.off_b)[ref] + dot3(n_ref, p_ref);

  // ---- the 2-D clip in the reference face's frame ----
  float p0[3], w1[3], e0[3], t1[3], t2[3];
  world_vert(v_ref, fv_ref[0], r_ref, p_ref, p0);
  world_vert(v_ref, fv_ref[1], r_ref, p_ref, w1);
#pragma unroll
  for (int c = 0; c < 3; ++c) e0[c] = w1[c] - p0[c];
  const float inv = 1.0f / clamp_min(sqrtf(clamp_min(dot3(e0, e0), 0.0f)), 1e-9f);
#pragma unroll
  for (int c = 0; c < 3; ++c) t1[c] = e0[c] * inv;
  t2[0] = n_ref[1] * t1[2] - n_ref[2] * t1[1];
  t2[1] = n_ref[2] * t1[0] - n_ref[0] * t1[2];
  t2[2] = n_ref[0] * t1[1] - n_ref[1] * t1[0];

  const int cap = 2 * d.e;
  float pu[CAPMAX], pv[CAPMAX], ps[CAPMAX];
#pragma unroll
  for (int k = 0; k < CAPMAX; ++k) pu[k] = pv[k] = ps[k] = 0.0f;
  for (int k = 0; k < d.e; ++k) {
    float q[3], rel[3];
    world_vert(v_inc, fv_inc[k], r_inc, p_inc, q);
#pragma unroll
    for (int c = 0; c < 3; ++c) rel[c] = q[c] - p0[c];
    put_slot<CAPMAX>(pu, k, dot3(rel, t1));
    put_slot<CAPMAX>(pv, k, dot3(rel, t2));
    put_slot<CAPMAX>(ps, k, dot3(q, n_ref) - off_ref);
  }
  int m_cnt = inc_cnt;
  // the reference polygon's vertex k in its frame: (ru_k, rv_k)
  float rel0[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) rel0[c] = p0[c] - p0[c];
  const float ru0 = dot3(rel0, t1), rv0 = dot3(rel0, t2);
  float ru_k = ru0, rv_k = rv0;
  for (int k = 0; k < d.e; ++k) {
    float ru_next = ru0, rv_next = rv0;  // vertex k + 1's own (not the wrap)
    if (k + 1 < d.e) {
      float q[3], rel[3];
      world_vert(v_ref, fv_ref[k + 1], r_ref, p_ref, q);
#pragma unroll
      for (int c = 0; c < 3; ++c) rel[c] = q[c] - p0[c];
      ru_next = dot3(rel, t1);
      rv_next = dot3(rel, t2);
    }
    const bool wrapped = k + 1 >= d.e || k + 1 == ref_cnt;
    const float ru_n = wrapped ? ru0 : ru_next, rv_n = wrapped ? rv0 : rv_next;
    const float e_u = ru_n - ru_k, e_v = rv_n - rv_k;
    const float on = k < ref_cnt ? 1.0f : 0.0f;
    const float cu = e_v * on, cv = -e_u * on;
    const float dd = (e_v * ru_k - e_u * rv_k) * on + (1.0f - on) * 1e30f;
    clip<CAPMAX>(pu, pv, ps, m_cnt, cap, cu, cv, dd);
    ru_k = ru_next;
    rv_k = rv_next;
  }
  float n_face[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) n_face[c] = ref_is_a ? -n_ref[c] : n_ref[c];

  // ---- the edge-edge contact along the best axis ----
  float ax[3], alen, t_ax;
#pragma unroll
  for (int c = 0; c < 3; ++c) ax[c] = gemm9(t.l_ax + (size_t)best_e * 27 + 9 * c, s.m, (p.orders & kSplitAxes) != 0);
  axis_terms(ax, s, alen, t_ax);
  const float sgn = t_ax < 0.0f ? -1.0f : 1.0f;
  const float scl = sgn / clamp_min(alen, 1e-9f);
  float ax_u[3], n_edge[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) ax_u[c] = ax[c] * scl;
  mat_vec(s.ra, ax_u, n_edge);
  const float* sup_a = t.c_av + (size_t)best_e * d.v * 9;
  const float* sup_b = t.c_bv + (size_t)best_e * d.v * 9;
  int ea = kNone, eb = kNone;
  float best_a = 0.0f, best_b = 0.0f;
  for (int e = r; e < d.e2; e += kGroup) {
    const float sa0 = tsum9(sup_a + 9 * t.i0a[e], s.m) * sgn;
    const float sa1 = tsum9(sup_a + 9 * t.i1a[e], s.m) * sgn;
    const float sc_a = max_nan(sa0, sa1) + (t.emask_a[e] > 0.0f ? 0.0f : kBig);
    const float sb0 = tsum9(sup_b + 9 * t.i0b[e], s.m) * sgn;
    const float sb1 = tsum9(sup_b + 9 * t.i1b[e], s.m) * sgn;
    const float sc_b = min_nan(sb0, sb1) - (t.emask_b[e] > 0.0f ? 0.0f : kBig);
    if (ea == kNone || sc_a < best_a) {
      best_a = sc_a;
      ea = e;
    }
    if (eb == kNone || sc_b > best_b) {
      best_b = sc_b;
      eb = e;
    }
  }
  group_argmin(best_a, ea);
  group_argmax(best_b, eb);
  float ea0[3], ea1[3], eb0[3], eb1[3];
  world_vert(t.verts_a, t.i0a[ea], s.ra, s.pa, ea0);
  world_vert(t.verts_a, t.i1a[ea], s.ra, s.pa, ea1);
  world_vert(t.verts_b, t.i0b[eb], s.rb, s.pb, eb0);
  world_vert(t.verts_b, t.i1b[eb], s.rb, s.pb, eb1);
  float d1[3], d2v[3], r0[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    d1[c] = ea1[c] - ea0[c];
    d2v[c] = eb1[c] - eb0[c];
    r0[c] = ea0[c] - eb0[c];
  }
  const float a11 = dot3(d1, d1), a22 = dot3(d2v, d2v), a12 = dot3(d1, d2v);
  const float b1 = dot3(d1, r0), b2 = dot3(d2v, r0);
  const float den = a11 * a22 - a12 * a12;
  float sp = fabsf(den) > 1e-9f ? (a12 * b2 - a22 * b1) / den : 0.0f;
  sp = clamp01(sp);
  float tp = a22 > 1e-9f ? (b2 + a12 * sp) / a22 : 0.0f;
  tp = clamp01(tp);
  if (a11 > 1e-9f) sp = clamp01((a12 * tp - b1) / a11);
  float edge_point[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) edge_point[c] = ((ea0[c] + d1[c] * sp) + (eb0[c] + d2v[c] * tp)) * 0.5f;
  const float edge_depth = -edge_sep;

  // ---- slot depths, validity folded in, and the kk picks ----
  const bool movable = p.inv_mass[ia] > 0.0f || p.inv_mass[ib] > 0.0f;
  const bool base_valid = lane_on && movable && p.stype[ia] == kShapeHull && p.stype[ib] == kShapeHull;
  const bool face_ok = !separated && !edge_wins;
  float score[CAPMAX + 1];
#pragma unroll
  for (int k = 0; k <= CAPMAX; ++k) {
    float dep = 0.0f;
    if (k < cap) {
      const float dr = -ps[k];
      dep = (k < m_cnt && dr > 0.0f && face_ok) ? dr : 0.0f;
    } else if (k == cap) {
      dep = (edge_wins && edge_depth > 0.0f) ? edge_depth : 0.0f;
    }
    score[k] = (base_valid && dep > 0.0f) ? dep : -kBig;
  }
  const float mu = sqrtf(p.friction[ia] * p.friction[ib]);
  const float rest = max_nan(p.restitution[ia], p.restitution[ib]);
  const int lo = min(ia, ib), hi = max(ia, ib);
  const int base_key = p.has_key ? (lo * p.n + hi) * (cap + 1) : 0;
  const size_t c_all = (size_t)p.kk * p.stride;
  for (int k = 0; k < p.kk; ++k) {
    float best = score[0];
    int bidx = 0;
#pragma unroll
    for (int q = 1; q <= CAPMAX; ++q) {
      if (q <= cap && score[q] > best) {
        best = score[q];
        bidx = q;
      }
    }
    if (valid && k % kGroup == r) {
      const bool act = best > 0.0f;
      const bool is_edge = bidx == cap;
      const float u = is_edge ? 0.0f : get_slot<CAPMAX>(pu, bidx);
      const float v = is_edge ? 0.0f : get_slot<CAPMAX>(pv, bidx);
      const float w = is_edge ? 0.0f : get_slot<CAPMAX>(ps, bidx);
      const size_t row = (size_t)k * p.stride + l;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float face_pt = p0[c] + u * t1[c] + v * t2[c] + w * n_ref[c];
        p.point[c * c_all + row] = is_edge ? edge_point[c] : face_pt;
        p.normal[c * c_all + row] = is_edge ? n_edge[c] : n_face[c];
      }
      p.depth[row] = act ? best : 0.0f;
      p.active[row] = act;
      p.key[row] = (p.has_key && act) ? base_key + bidx : 0;
      p.ia_out[row] = ia;
      p.ib_out[row] = ib;
      p.fric_out[row] = mu;
      p.rest_out[row] = rest;
    }
#pragma unroll
    for (int q = 0; q <= CAPMAX; ++q)
      if (q == bidx) score[q] = -kBig;
  }
}

template <int CAPMAX>
cudaError_t launch_picks(const Args& a, cudaStream_t st) {
  const int lanes = kPickThreads / kGroup;
  list_picks_kernel<CAPMAX><<<(a.p + lanes - 1) / lanes, kPickThreads, 0, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

// The pair contacts of one type-pair segment: lanes [lane0, lane0 + p) of
// the candidates (body_a, body_b, mask [P_tot]), written to rows k·stride +
// lane0 + j (k < kk) of the group's outputs (point, normal [3, kk·stride];
// the rest [kk·stride]). ftab / itab: the type pair's packed tables at dims
// (f, v, d2, e, e2), of ftab_n floats and itab_n ints (refused unless the
// layout's); sep: scratch of (2f + d2)·p floats; sink: int64 [2]
// (SAT lanes, overlaps) or NULL; orders: which tables' products sum as
// split4 at p lanes (1 faces, 2 axis vertices, 4 axes).
extern "C" int hl_pair_contacts(const float* pos, const float* quat, const float* inv_mass, const int* stype,
                                const float* friction, const float* restitution, const int* body_a,
                                const int* body_b, const bool* mask, const float* ftab, int ftab_n,
                                const int* itab, int itab_n, float* sep,
                                float* point, float* normal, float* depth, bool* active, float* fric_out,
                                float* rest_out, int* key, int* ia_out, int* ib_out, void* sink, int n, int lane0,
                                int p, int stride, int f, int v, int d2, int e, int e2, int kk, int has_key,
                                int orders, void* stream) {
  const Dims d = {f, v, d2, e, e2};
  if (p < 0 || n < 1 || f < 1 || v < 1 || d2 < 1 || e < 2 || e2 < 1 || kk < 1 || kk > 2 * e + 1 ||
      lane0 < 0 || lane0 + p > stride || 2 * e > 64 || ftab_n != ftab_floats(d) || itab_n != itab_ints(d))
    return (int)cudaErrorInvalidValue;
  if (p == 0) return (int)cudaSuccess;
  const int face_splits = (2 * f + kFacesPerSplit - 1) / kFacesPerSplit;
  const int axis_splits = (d2 + kAxesPerSplit - 1) / kAxesPerSplit;
  const int face_rows = kFacesPerSplit * v, axis_rows = kAxesPerSplit * (2 * v + 3);
  const size_t smem = sizeof(float) * kRow * (size_t)(face_rows > axis_rows ? face_rows : axis_rows);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  Args a = {pos, quat, inv_mass, stype, friction, restitution, body_a, body_b, mask, ftab, itab, sep, point, normal,
            depth, active, fric_out, rest_out, key, ia_out, ib_out, (unsigned long long*)sink, d, n, lane0, p,
            stride, kk, has_key, orders};
  const cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((p + kSatLanes - 1) / kSatLanes, face_splits + axis_splits);
  list_sat_kernel<<<grid, kSatLanes, smem, st>>>(a, face_splits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int cap = 2 * e;
  if (cap <= 8) return (int)launch_picks<8>(a, st);
  if (cap <= 16) return (int)launch_picks<16>(a, st);
  if (cap <= 32) return (int)launch_picks<32>(a, st);
  return (int)launch_picks<64>(a, st);
}
