// Banded contact solves (Hopper, sm_90a): four TPU kernels share this file.
//
//   bs_banded_solve       replaces banded_sweeps_fused (kernel 2.3,
//                         physics_tpu/solver/contacts_pallas.py:736; body
//                         _make_kernel with prep= and integrate=, :245-626);
//   bs_prep_consts        replaces prep_consts (kernel 2.6, :1199; body
//                         _make_prep_kernel :1154);
//   bs_banded_sweeps      replaces banded_sweeps (kernel 2.5, :628; body
//                         _make_kernel without prep=, with or without its
//                         integrate= epilogue);
//   bs_banded_sweep_once  replaces banded_sweep_once (kernel 2.7, :956; body
//                         _make_sweep1_kernel :914), one sweep of the
//                         row-sharded solve (at the end of this file).
// Sweep math _sweep_tile_math :92, constants _prep_consts_math :1086. Plain
// versions: physics_tpu_torch/solver/banded_solve.py (banded_sweeps_fused_plain,
// prep_consts_plain, banded_sweeps_plain, banded_sweep_once_plain), which the
// device functions below follow operation by operation.
//
// The solve is projected Jacobi with split impulses on a packed velocity
// table z [16, NPAD] (rows 0:3 v, 3:6 ω, 8:11 pseudo v, 11:14 pseudo ω,
// 14 contact degree). Launch sequence of 2.3, all on the caller's stream:
//   init      z and its snapshot ← (v, ω) of the geometry table, rest 0;
//   sweep 0   one thread per contact: endpoints from the table, the anchored
//             re-derivation of point/normal/depth, the [48, Cp] constants,
//             then the degree scatter and the warm-start impulses;
//   sweep s   copy z → snapshot, then one thread per contact reads the
//             snapshot and atomically adds its deltas into z — Jacobi: every
//             contact of a sweep sees the same snapshot;
//   integrate one thread per rank: pos/quat from the final z.
// 2.5 is the same sequence over constants that 2.6 computed beforehand (one
// thread per contact, both endpoints gathered by rank): z and its snapshot
// start as a copy of z0, sweep 0 is the degree / warm-start pre-pass alone,
// and endpoint ranks come from the tile's window base plus la/lb (−1: no
// endpoint, as the TPU kernel's band check left it). On the TPU the whole
// loop was one kernel whose grid ran in order, so tile t could integrate its
// ranks right after its last scatter; blocks on the GPU run in no order, so
// integration is its own launch.
//
// What bounds it on the H100: per sweep 24.6k contacts × (45 constant loads,
// 28 z gathers, ~250 flops, 24 atomics) — about 6 MB of traffic, L2-resident,
// so each sweep is a few microseconds of work and the launch sequence
// (2 + 2·sweeps launches and copies) is latency-bound. The z table
// (16 × 4352 × 4 B ≈ 272 KB) exceeds one block's 227 KB of shared memory, so
// it lives in global memory/L2 and blocks communicate through atomics. A
// persistent kernel or a CUDA graph is later work. Atomic f32 sums land in a
// different order every run, so results match the plain version to a
// tolerance, not bitwise; 2.6 has no sums across contacts and matches bit for
// bit.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kZRows = 16;
constexpr int kRConst = 48;

// consts rows (contacts_pallas._R_*)
constexpr int R_RA = 0, R_RB = 3, R_N = 6, R_T1 = 9, R_T2 = 12;
constexpr int R_IKN = 15, R_IKT1 = 16, R_IKT2 = 17, R_VTGT = 18, R_BIAS = 19;
constexpr int R_FRIC = 20, R_RELAX = 21, R_IMA = 22, R_IMB = 23, R_IWA = 24, R_IWB = 33;
constexpr int R_LAM0 = 42, R_DEPTH = 45, R_RANKA = 46, R_RANKB = 47;
constexpr int kPrepRows = R_DEPTH;  // rows the constants math fills: 2.6's output

constexpr int FLAG_USE_SPLIT = 1, FLAG_ANCHORED = 2, FLAG_INTEGRATE = 4, FLAG_RENORM = 8;

struct Params {
  const float* table;
  const float* warm8;
  const float* geom;
  float* z;
  float* zread;
  float* lam;
  float* consts;
  float* pq;
  const float* pos0;   // rows of the pre-step pos (x, y, z) ...
  const float* quat0;  // ... and quat (w, x, y, z), row stride npad
  int cp, npad;
  float baum_over_dt, slop, relaxation, dt;
  int flags;
};

// rot9 of the anchored refresh (contacts_pallas.py:447-455)
__device__ __forceinline__ void rot9(float w, float x, float y, float z, float* r) {
  r[0] = 1.0f - 2.0f * (y * y + z * z);
  r[1] = 2.0f * (x * y - w * z);
  r[2] = 2.0f * (x * z + w * y);
  r[3] = 2.0f * (x * y + w * z);
  r[4] = 1.0f - 2.0f * (x * x + z * z);
  r[5] = 2.0f * (y * z - w * x);
  r[6] = 2.0f * (x * z - w * y);
  r[7] = 2.0f * (y * z + w * x);
  r[8] = 1.0f - 2.0f * (x * x + y * y);
}

__device__ __forceinline__ float effmass(V3 d, float ima, float imb, const float* iwa, const float* iwb, V3 ra,
                                         V3 rb) {
  const float ta = dot(d, cross(mat_vec(iwa, cross(ra, d)), ra));
  const float tb = dot(d, cross(mat_vec(iwb, cross(rb, d)), rb));
  return ima + imb + ta + tb;
}

// Endpoint geometry of the solve block (unified table rows 0:24).
__device__ __forceinline__ void load_solve(const float* geom, int npad, int rank, float* g) {
#pragma unroll
  for (int k = 0; k < 24; ++k) g[k] = rank >= 0 ? geom[(size_t)k * npad + rank] : 0.f;
}

__device__ __forceinline__ float cget(const Params& p, int row, int j) { return p.consts[(size_t)row * p.cp + j]; }

// One Jacobi sweep for contact j with endpoint ranks rank_a/rank_b (−1: none)
// (contacts_pallas._sweep_tile_math), reading the snapshot and adding the
// deltas into z. vel_on/pos_on/warm_f/degf are the sweep's 0/1 switches.
__device__ void sweep_contact(const Params& p, int j, int rank_a, int rank_b, float vel_on, float pos_on,
                              float warm_f, float degf, bool last) {
  float za[kZRows], zb[kZRows];
#pragma unroll
  for (int k = 0; k < kZRows; ++k) {
    za[k] = rank_a >= 0 ? p.zread[(size_t)k * p.npad + rank_a] : 0.f;
    zb[k] = rank_b >= 0 ? p.zread[(size_t)k * p.npad + rank_b] : 0.f;
  }
  const V3 r_a = mk(cget(p, R_RA, j), cget(p, R_RA + 1, j), cget(p, R_RA + 2, j));
  const V3 r_b = mk(cget(p, R_RB, j), cget(p, R_RB + 1, j), cget(p, R_RB + 2, j));
  const V3 nrm = mk(cget(p, R_N, j), cget(p, R_N + 1, j), cget(p, R_N + 2, j));
  const V3 t1 = mk(cget(p, R_T1, j), cget(p, R_T1 + 1, j), cget(p, R_T1 + 2, j));
  const V3 t2 = mk(cget(p, R_T2, j), cget(p, R_T2 + 1, j), cget(p, R_T2 + 2, j));
  const float inv_k_n = cget(p, R_IKN, j), inv_k_t1 = cget(p, R_IKT1, j), inv_k_t2 = cget(p, R_IKT2, j);
  const float v_target = cget(p, R_VTGT, j), bias = cget(p, R_BIAS, j);
  const float friction = cget(p, R_FRIC, j);
  const float inv_m_a = cget(p, R_IMA, j), inv_m_b = cget(p, R_IMB, j);
  float iw_a[9], iw_b[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    iw_a[k] = cget(p, R_IWA + k, j);
    iw_b[k] = cget(p, R_IWB + k, j);
  }
  const float relax = cget(p, R_RELAX, j) / fmaxf(fmaxf(za[14], zb[14]), 1.0f);

  const size_t cp = (size_t)p.cp;
  const float lam_n = p.lam[j], lam_t1 = p.lam[cp + j], lam_t2 = p.lam[2 * cp + j], lam_b = p.lam[3 * cp + j];

  const V3 va = add(mk(za[0], za[1], za[2]), cross(mk(za[3], za[4], za[5]), r_a));
  const V3 vb = add(mk(zb[0], zb[1], zb[2]), cross(mk(zb[3], zb[4], zb[5]), r_b));
  const V3 v = sub(va, vb);
  const float v_n = dot(nrm, v);
  const float d_lam = (v_target - v_n) * inv_k_n * relax * vel_on;
  float lam_n_new = fmaxf(lam_n + d_lam, 0.f);
  const float lim = friction * lam_n_new;
  const float v_t1 = dot(t1, v);
  float lam_t1_new = fminf(fmaxf(lam_t1 - v_t1 * inv_k_t1 * relax * vel_on, -lim), lim);
  const float v_t2 = dot(t2, v);
  float lam_t2_new = fminf(fmaxf(lam_t2 - v_t2 * inv_k_t2 * relax * vel_on, -lim), lim);

  const V3 pva = add(mk(za[8], za[9], za[10]), cross(mk(za[11], za[12], za[13]), r_a));
  const V3 pvb = add(mk(zb[8], zb[9], zb[10]), cross(mk(zb[11], zb[12], zb[13]), r_b));
  const float pv_n = dot(nrm, sub(pva, pvb));
  const float d_lam_b = (bias - pv_n) * inv_k_n * relax * pos_on;
  float lam_b_new = fmaxf(lam_b + d_lam_b, 0.f);

  if (p.flags & FLAG_USE_SPLIT) {
    const float nf = 1.0f - warm_f;
    lam_n_new = warm_f * cget(p, R_LAM0, j) + nf * lam_n_new;
    lam_t1_new = warm_f * cget(p, R_LAM0 + 1, j) + nf * lam_t1_new;
    lam_t2_new = warm_f * cget(p, R_LAM0 + 2, j) + nf * lam_t2_new;
    lam_b_new = nf * lam_b_new;
  }

  const V3 imp = add(add(scale(nrm, lam_n_new - lam_n), scale(t1, lam_t1_new - lam_t1)),
                     scale(t2, lam_t2_new - lam_t2));
  const V3 pimp = scale(nrm, lam_b_new - lam_b);

  p.lam[j] = lam_n_new;
  p.lam[cp + j] = lam_t1_new;
  p.lam[2 * cp + j] = lam_t2_new;
  p.lam[3 * cp + j] = (last && (p.flags & FLAG_ANCHORED)) ? cget(p, R_DEPTH, j) : lam_b_new;

#pragma unroll
  for (int side = 0; side < 2; ++side) {
    const int rank = side == 0 ? rank_a : rank_b;
    if (rank < 0) continue;
    const float sign = side == 0 ? 1.0f : -1.0f;
    const float inv_m = side == 0 ? inv_m_a : inv_m_b;
    const float* iw = side == 0 ? iw_a : iw_b;
    const V3 r = side == 0 ? r_a : r_b;
    const V3 dv = scale(imp, sign * inv_m);
    const V3 dw = scale(mat_vec(iw, cross(r, imp)), sign);
    const V3 pdv = scale(pimp, sign * inv_m);
    const V3 pdw = scale(mat_vec(iw, cross(r, pimp)), sign);
    float* zc = p.z + rank;
    const size_t np = (size_t)p.npad;
    atomicAdd(zc + 0 * np, dv.x);
    atomicAdd(zc + 1 * np, dv.y);
    atomicAdd(zc + 2 * np, dv.z);
    atomicAdd(zc + 3 * np, dw.x);
    atomicAdd(zc + 4 * np, dw.y);
    atomicAdd(zc + 5 * np, dw.z);
    atomicAdd(zc + 8 * np, pdv.x);
    atomicAdd(zc + 9 * np, pdv.y);
    atomicAdd(zc + 10 * np, pdv.z);
    atomicAdd(zc + 11 * np, pdw.x);
    atomicAdd(zc + 12 * np, pdw.y);
    atomicAdd(zc + 13 * np, pdw.z);
    if (degf != 0.f) atomicAdd(zc + 14 * np, degf);
  }
}

__global__ void init_kernel(Params p) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= p.npad) return;
  const size_t np = (size_t)p.npad;
#pragma unroll
  for (int r = 0; r < kZRows; ++r) {
    const float v = r < 6 ? p.geom[(size_t)(13 + r) * np + c] : 0.f;
    p.z[r * np + c] = v;
    p.zread[r * np + c] = v;
  }
}

// contacts_pallas._prep_consts_math: the solve constants of one contact, rows
// 0:45 of c (R_* layout), from its endpoint gathers ga/gb (solve rows 0:24 of
// the geometry table; zeros for a missing endpoint) and its fields. Shared by
// 2.3's sweep 0 and 2.6.
__device__ __forceinline__ void prep_consts_math(const Params& p, const float* ga, const float* gb, V3 pt, V3 nrm,
                                                 float depth, float fric, float rest, float actf,
                                                 const float* lam0, float has_bf, float* c) {
  const float inv_m_a = ga[12] * actf;
  const float inv_m_b = gb[12] * has_bf;
  float iw_a[9], iw_b[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    iw_a[k] = ga[3 + k] * actf;
    iw_b[k] = gb[3 + k] * has_bf;
  }
  const V3 r_a = sub(pt, mk(ga[0], ga[1], ga[2]));
  const V3 r_b = sub(pt, mk(gb[0], gb[1], gb[2]));
  const float ax = fabsf(nrm.x), ay = fabsf(nrm.y), az = fabsf(nrm.z);
  const bool use_x = (ax <= ay) && (ax <= az);
  const bool use_y = (!use_x) && (ay <= az);
  const V3 e = mk((float)use_x, (float)use_y, (float)(!(use_x || use_y)));
  V3 t1 = cross(nrm, e);
  t1 = scale(t1, 1.0f / fmaxf(sqrtf(fmaxf(dot(t1, t1), 0.f)), 1e-9f));
  const V3 t2 = cross(nrm, t1);
  const float inv_k_n = 1.0f / fmaxf(effmass(nrm, inv_m_a, inv_m_b, iw_a, iw_b, r_a, r_b), 1e-9f);
  const float inv_k_t1 = 1.0f / fmaxf(effmass(t1, inv_m_a, inv_m_b, iw_a, iw_b, r_a, r_b), 1e-9f);
  const float inv_k_t2 = 1.0f / fmaxf(effmass(t2, inv_m_a, inv_m_b, iw_a, iw_b, r_a, r_b), 1e-9f);
  const V3 va0 = add(mk(ga[13], ga[14], ga[15]), cross(mk(ga[16], ga[17], ga[18]), r_a));
  const V3 vb0 = scale(add(mk(gb[13], gb[14], gb[15]), cross(mk(gb[16], gb[17], gb[18]), r_b)), has_bf);
  const float v_n0 = dot(nrm, sub(va0, vb0));
  const float bias = p.baum_over_dt * fmaxf(depth - p.slop, 0.f);
  const float bounce = rest * fmaxf(-v_n0, 0.f);
  const float v_target = (p.flags & FLAG_USE_SPLIT) ? bounce : fmaxf(bias, bounce);

  c[R_RA] = r_a.x; c[R_RA + 1] = r_a.y; c[R_RA + 2] = r_a.z;
  c[R_RB] = r_b.x; c[R_RB + 1] = r_b.y; c[R_RB + 2] = r_b.z;
  c[R_N] = nrm.x; c[R_N + 1] = nrm.y; c[R_N + 2] = nrm.z;
  c[R_T1] = t1.x; c[R_T1 + 1] = t1.y; c[R_T1 + 2] = t1.z;
  c[R_T2] = t2.x; c[R_T2 + 1] = t2.y; c[R_T2 + 2] = t2.z;
  c[R_IKN] = inv_k_n; c[R_IKT1] = inv_k_t1; c[R_IKT2] = inv_k_t2;
  c[R_VTGT] = v_target; c[R_BIAS] = bias; c[R_FRIC] = fric; c[R_RELAX] = p.relaxation * actf;
  c[R_IMA] = inv_m_a; c[R_IMB] = inv_m_b;
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    c[R_IWA + k] = iw_a[k];
    c[R_IWB + k] = iw_b[k];
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) c[R_LAM0 + k] = lam0[k] * actf;
}

// Sweep 0: constants (contacts_pallas._prep_consts_math, with the anchored
// refresh of :440-481), then the degree / warm-start pass.
__global__ void __launch_bounds__(kThreads) prep_kernel(Params p, bool last) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= p.cp) return;
  const size_t cp = (size_t)p.cp;
  // endpoints are read by rank: the table's band keeps them within
  // [b·128, b·128 + wtot) of their bucket b, as the TPU window required
  float tb[25];
  const int trows = (p.flags & FLAG_ANCHORED) ? 25 : 16;
  for (int k = 0; k < trows; ++k) tb[k] = p.table[(size_t)k * cp + j];
  const float actf = tb[9];
  const bool act = actf > 0.f;
  const int ra = (int)tb[13];
  const int rb1 = (int)tb[14];
  const bool has_b = act && (rb1 > 0);
  const int rank_a = act ? ra : -1;
  const int rank_b = has_b ? rb1 - 1 : -1;
  float ga[24], gb[24];
  load_solve(p.geom, p.npad, rank_a, ga);
  load_solve(p.geom, p.npad, rank_b, gb);

  V3 p_t, n_t;
  float d_t, actf_t;
  if (p.flags & FLAG_ANCHORED) {
    float r_a9[9], r_b9[9];
    rot9(ga[19], ga[20], ga[21], ga[22], r_a9);
    rot9(gb[19], gb[20], gb[21], gb[22], r_b9);
    const V3 aw = mat_vec(r_a9, mk(tb[16], tb[17], tb[18]));
    const V3 a_pt = mk(ga[0] + aw.x, ga[1] + aw.y, ga[2] + aw.z);
    const V3 bw = mat_vec(r_b9, mk(tb[19], tb[20], tb[21]));
    const float hbf = (float)has_b;
    const V3 b_pt = mk(hbf * (gb[0] + bw.x) + (1.0f - hbf) * tb[19], hbf * (gb[1] + bw.y) + (1.0f - hbf) * tb[20],
                       hbf * (gb[2] + bw.z) + (1.0f - hbf) * tb[21]);
    const V3 n_w = mat_vec(r_a9, mk(tb[22], tb[23], tb[24]));
    const float sep = n_w.x * (a_pt.x - b_pt.x) + n_w.y * (a_pt.y - b_pt.y) + n_w.z * (a_pt.z - b_pt.z);
    d_t = tb[6] - sep;
    actf_t = actf * (float)(d_t > 0.f);
    p_t = a_pt;
    n_t = n_w;
  } else {
    p_t = mk(tb[0], tb[1], tb[2]);
    n_t = mk(tb[3], tb[4], tb[5]);
    d_t = tb[6];
    actf_t = actf;
  }
  const float has_bf = (float)(has_b && (actf_t > 0.f));

  float c[kRConst];
  const float lam0[3] = {p.warm8[j], p.warm8[cp + j], p.warm8[2 * cp + j]};
  prep_consts_math(p, ga, gb, p_t, n_t, d_t, tb[7], tb[8], actf_t, lam0, has_bf, c);
  c[R_DEPTH] = (p.flags & FLAG_ANCHORED) ? d_t * actf_t : 0.f;
  c[R_RANKA] = (float)rank_a;
  c[R_RANKB] = (float)rank_b;
#pragma unroll
  for (int k = 0; k < kRConst; ++k) p.consts[(size_t)k * cp + j] = c[k];
#pragma unroll
  for (int k = 0; k < 4; ++k) p.lam[(size_t)k * cp + j] = 0.f;

  sweep_contact(p, j, rank_a, rank_b, 0.f, 0.f, 1.0f, 1.0f, last);
}

__global__ void __launch_bounds__(kThreads) sweep_kernel(Params p, float vel_on, float pos_on, bool last) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= p.cp) return;
  sweep_contact(p, j, (int)cget(p, R_RANKA, j), (int)cget(p, R_RANKB, j), vel_on, pos_on, 0.f, 0.f, last);
}

// exp-map of a rotation vector (identity at 0), as the TPU epilogue's expq
__device__ __forceinline__ void expq(float vx, float vy, float vz, float* q) {
  const float nn = sqrtf(vx * vx + vy * vy + vz * vz);
  const float safe = nn > 0.f ? nn : 1.0f;
  const float half = nn * 0.5f;
  const float sfac = sinf(half) / safe;
  q[0] = cosf(half);
  q[1] = vx * sfac;
  q[2] = vy * sfac;
  q[3] = vz * sfac;
}

__device__ __forceinline__ void qmul(const float* a, const float* b, float* o) {
  o[0] = a[0] * b[0] - a[1] * b[1] - a[2] * b[2] - a[3] * b[3];
  o[1] = a[0] * b[1] + a[1] * b[0] + a[2] * b[3] - a[3] * b[2];
  o[2] = a[0] * b[2] - a[1] * b[3] + a[2] * b[0] + a[3] * b[1];
  o[3] = a[0] * b[3] + a[1] * b[2] - a[2] * b[1] + a[3] * b[0];
}

__device__ __forceinline__ void qnorm(float* a) {
  const float inv = 1.0f / fmaxf(sqrtf(a[0] * a[0] + a[1] * a[1] + a[2] * a[2] + a[3] * a[3]), 1e-12f);
#pragma unroll
  for (int k = 0; k < 4; ++k) a[k] = a[k] * inv;
}

// Position integration from the final z (contacts_pallas.py:563-619):
// pos += (v + pv)·dt, q ← exp(ω dt) ∘ normalize(exp(pω dt) ∘ q).
__global__ void integrate_kernel(Params p) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= p.npad) return;
  const size_t np = (size_t)p.npad;
  float own[kZRows];
#pragma unroll
  for (int r = 0; r < kZRows; ++r) own[r] = p.z[r * np + c];
  const float dt = p.dt;
  const float q0[4] = {p.quat0[c], p.quat0[np + c], p.quat0[2 * np + c], p.quat0[3 * np + c]};
  float e1[4], q1[4], e2[4], q2[4];
  expq(own[11] * dt, own[12] * dt, own[13] * dt, e1);
  qmul(e1, q0, q1);
  qnorm(q1);
  expq(own[3] * dt, own[4] * dt, own[5] * dt, e2);
  qmul(e2, q1, q2);
  if (p.flags & FLAG_RENORM) qnorm(q2);
  p.pq[0 * np + c] = p.pos0[0 * np + c] + (own[0] + own[8]) * dt;
  p.pq[1 * np + c] = p.pos0[1 * np + c] + (own[1] + own[9]) * dt;
  p.pq[2 * np + c] = p.pos0[2 * np + c] + (own[2] + own[10]) * dt;
#pragma unroll
  for (int k = 0; k < 4; ++k) p.pq[(3 + k) * np + c] = q2[k];
  p.pq[7 * np + c] = 0.f;
}

// Endpoint rank of a window-local index (−1: none).
__device__ __forceinline__ int win_rank(const int* bases, const int* loc, int tile, int j) {
  const int l = loc[j];
  return l >= 0 ? bases[j / tile] + l : -1;
}

// 2.6: the solve constants of contact j from its cin rows (point 0:3, normal
// 3:6, depth, friction, restitution, activity, λ₀ 10:13, has_b) and its
// endpoints' geometry: rows 0:45 (the fused solve's depth and rank rows are
// not part of 2.6's output; 2.5 refuses the anchored flag that reads depth).
__global__ void __launch_bounds__(kThreads) prep_consts_kernel(Params p, const int* bases, const int* la,
                                                               const int* lb, const float* cin, int tile) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= p.cp) return;
  const size_t cp = (size_t)p.cp;
  float ci[14];
#pragma unroll
  for (int k = 0; k < 14; ++k) ci[k] = cin[(size_t)k * cp + j];
  float ga[24], gb[24];
  load_solve(p.geom, p.npad, win_rank(bases, la, tile, j), ga);
  load_solve(p.geom, p.npad, win_rank(bases, lb, tile, j), gb);
  float c[kPrepRows];
  prep_consts_math(p, ga, gb, mk(ci[0], ci[1], ci[2]), mk(ci[3], ci[4], ci[5]), ci[6], ci[7], ci[8], ci[9], ci + 10,
                   ci[13], c);
#pragma unroll
  for (int k = 0; k < kPrepRows; ++k) p.consts[(size_t)k * cp + j] = c[k];
}

// 2.5: one sweep over constants computed beforehand.
__global__ void __launch_bounds__(kThreads) banded_sweep_kernel(Params p, const int* bases, const int* la,
                                                                const int* lb, int tile, float vel_on, float pos_on,
                                                                float warm_f, float degf) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= p.cp) return;
  sweep_contact(p, j, win_rank(bases, la, tile, j), win_rank(bases, lb, tile, j), vel_on, pos_on, warm_f, degf,
                false);
}

}  // namespace

extern "C" int bs_banded_solve(const float* table, const float* warm8, const float* geom, float* z_out,
                               float* lam_out, float* pq_out, float* consts, float* zread, int cp, int npad,
                               int trows, int n_sweeps, int vel_iters, int pos_iters, float baum_over_dt,
                               float slop, float relaxation, float dt, int flags, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const bool anchored = flags & FLAG_ANCHORED;
  if (n_sweeps < 1 || trows < (anchored ? 25 : 16) || ((flags & FLAG_INTEGRATE) && pq_out == nullptr))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.table = table;
  p.warm8 = warm8;
  p.geom = geom;
  p.z = z_out;
  p.zread = zread;
  p.lam = lam_out;
  p.consts = consts;
  p.pq = pq_out;
  p.pos0 = geom;
  p.quat0 = geom + 19 * (size_t)npad;
  p.cp = cp;
  p.npad = npad;
  p.baum_over_dt = baum_over_dt;
  p.slop = slop;
  p.relaxation = relaxation;
  p.dt = dt;
  p.flags = flags;
  const int cgrid = (p.cp + kThreads - 1) / kThreads;
  const int rgrid = (npad + kThreads - 1) / kThreads;
  init_kernel<<<rgrid, kThreads, 0, stream>>>(p);
  prep_kernel<<<cgrid, kThreads, 0, stream>>>(p, n_sweeps == 1);
  for (int s = 1; s < n_sweeps; ++s) {
    cudaError_t err = cudaMemcpyAsync(zread, z_out, sizeof(float) * kZRows * (size_t)npad,
                                      cudaMemcpyDeviceToDevice, stream);
    if (err != cudaSuccess) return (int)err;
    const int i = s - 1;
    sweep_kernel<<<cgrid, kThreads, 0, stream>>>(p, i < vel_iters ? 1.0f : 0.0f, i < pos_iters ? 1.0f : 0.0f,
                                                 s == n_sweeps - 1);
  }
  if (flags & FLAG_INTEGRATE) integrate_kernel<<<rgrid, kThreads, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

extern "C" int bs_prep_consts(const float* geom, const int* bases, const int* la, const int* lb, const float* cin,
                              float* consts, int cp, int npad, int tile, float baum_over_dt, float slop,
                              float relaxation, int flags, void* stream_ptr) {
  if (cp < 1 || tile < 1 || cp % tile) return (int)cudaErrorInvalidValue;
  Params p = {};
  p.geom = geom;
  p.consts = consts;
  p.cp = cp;
  p.npad = npad;
  p.baum_over_dt = baum_over_dt;
  p.slop = slop;
  p.relaxation = relaxation;
  p.flags = flags & FLAG_USE_SPLIT;
  prep_consts_kernel<<<(cp + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream_ptr>>>(p, bases, la, lb,
                                                                                                cin, tile);
  return (int)cudaGetLastError();
}

extern "C" int bs_banded_sweeps(const float* z0, const int* bases, const int* la, const int* lb, const float* consts,
                                const float* posq, float* z_out, float* lam_out, float* pq_out, float* zread, int cp,
                                int npad, int tile, int n_sweeps, int vel_iters, int pos_iters, float dt, int flags,
                                void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const bool integrate = flags & FLAG_INTEGRATE;
  if (cp < 1 || tile < 1 || cp % tile || n_sweeps < 1 || (flags & FLAG_ANCHORED) ||
      (integrate && (pq_out == nullptr || posq == nullptr)))
    return (int)cudaErrorInvalidValue;
  Params p = {};
  p.z = z_out;
  p.zread = zread;
  p.lam = lam_out;
  p.consts = const_cast<float*>(consts);  // read only: no sweep writes consts
  p.pq = pq_out;
  p.pos0 = posq;
  p.quat0 = posq + 3 * (size_t)npad;
  p.cp = cp;
  p.npad = npad;
  p.dt = dt;
  p.flags = flags;
  const size_t zbytes = sizeof(float) * kZRows * (size_t)npad;
  cudaError_t err = cudaMemcpyAsync(z_out, z0, zbytes, cudaMemcpyDeviceToDevice, stream);
  if (err == cudaSuccess) err = cudaMemcpyAsync(zread, z0, zbytes, cudaMemcpyDeviceToDevice, stream);
  if (err == cudaSuccess) err = cudaMemsetAsync(lam_out, 0, sizeof(float) * 4 * (size_t)cp, stream);
  if (err != cudaSuccess) return (int)err;
  const int cgrid = (cp + kThreads - 1) / kThreads;
  // sweep 0: the degree scatter and, with warm start, λ: 0 → λ₀
  banded_sweep_kernel<<<cgrid, kThreads, 0, stream>>>(p, bases, la, lb, tile, 0.f, 0.f, 1.0f, 1.0f);
  for (int s = 1; s < n_sweeps; ++s) {
    err = cudaMemcpyAsync(zread, z_out, zbytes, cudaMemcpyDeviceToDevice, stream);
    if (err != cudaSuccess) return (int)err;
    const int i = s - 1;
    banded_sweep_kernel<<<cgrid, kThreads, 0, stream>>>(p, bases, la, lb, tile, i < vel_iters ? 1.0f : 0.0f,
                                                        i < pos_iters ? 1.0f : 0.0f, 0.f, 0.f);
  }
  if (integrate) integrate_kernel<<<(npad + kThreads - 1) / kThreads, kThreads, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

// 2.7 (banded_sweep_once, contacts_pallas.py:956; body _make_sweep1_kernel
// :914): one sweep of a rank's contact tiles for the row-sharded solve. Every
// contact reads the snapshot z (never written) and adds its deltas into dz,
// which starts at zero; λ starts as a copy of lam_in and is updated in place.
// The caller sums dz over the ranks and adds it to z, which makes the next
// snapshot, so no snapshot copy is needed here. One launch of 2.5's sweep
// kernel with zread = z and z = dz; warm start is gated by FLAG_USE_SPLIT.
extern "C" int bs_banded_sweep_once(const float* z, const int* bases, const int* la, const int* lb,
                                    const float* consts, const float* lam_in, float* dz, float* lam_out, int cp,
                                    int npad, int tile, float vel_on, float pos_on, int warm, int deg_pass,
                                    void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (cp < 1 || tile < 1 || cp % tile) return (int)cudaErrorInvalidValue;
  Params p = {};
  p.z = dz;
  p.zread = const_cast<float*>(z);        // read only: the sweep writes dz
  p.lam = lam_out;
  p.consts = const_cast<float*>(consts);  // read only
  p.cp = cp;
  p.npad = npad;
  p.flags = warm ? FLAG_USE_SPLIT : 0;
  cudaError_t err = cudaMemsetAsync(dz, 0, sizeof(float) * kZRows * (size_t)npad, stream);
  if (err == cudaSuccess)
    err = cudaMemcpyAsync(lam_out, lam_in, sizeof(float) * 4 * (size_t)cp, cudaMemcpyDeviceToDevice, stream);
  if (err != cudaSuccess) return (int)err;
  banded_sweep_kernel<<<(cp + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      p, bases, la, lb, tile, vel_on, pos_on, warm ? 1.0f : 0.0f, deg_pass ? 1.0f : 0.0f);
  return (int)cudaGetLastError();
}
