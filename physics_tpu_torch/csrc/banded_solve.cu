// Banded contact solves (Hopper, sm_90a): four TPU kernels share this file.
//
//   bs_banded_solve       replaces banded_sweeps_fused (kernel 2.3,
//                         physics_tpu/solver/contacts_pallas.py:736; body
//                         _make_kernel with prep= and integrate=, :245-626);
//   bs_banded_sweeps      replaces prep_consts (kernel 2.6, :1199; body
//                         _make_prep_kernel :1154) and banded_sweeps (kernel
//                         2.5, :628; body _make_kernel without prep=, with
//                         or without its integrate= epilogue): 2.6 is folded
//                         into 2.5's sweep 0;
//   bs_sharded_sweep      replaces banded_sweep_once (kernel 2.7, :956; body
//                         _make_sweep1_kernel :914), one sweep of the
//                         row-sharded solve (sharded_sweep_kernel), with
//                         2.6 folded into its sweep 0 for the rank's slots.
// Sweep math _sweep_tile_math :92, constants _prep_consts_math :1086. Plain
// versions: physics_tpu_torch/solver/banded_solve.py (banded_sweeps_fused_plain,
// prep_consts_plain, banded_sweeps_plain, banded_sweep_once_plain), which the
// device functions below follow operation by operation.
//
// The solve is projected Jacobi with split impulses on a packed velocity
// table z [16, NPAD] (rows 0:3 v, 3:6 ω, 8:11 pseudo v, 11:14 pseudo ω,
// 14 contact degree). Sweep 0 builds each contact's constants (2.3: from
// the contact table and the geometry, with the anchored re-derivation of
// point/normal/depth; 2.5 and 2.7: 2.6's, from the contact rows `cin` and
// the geometry), scatters the endpoint degrees and applies the warm-start
// impulses; each later sweep
// reads a snapshot of z and adds every live contact's impulse deltas,
// relaxed by 1/degree and Coulomb-clamped (Jacobi: every contact of a sweep
// sees the same snapshot); the epilogue integrates pos/quat from the final
// z. On the TPU the whole loop was one kernel whose grid ran in order.
//
// 2.3 and 2.5 are one persistent cooperative launch each (solve_kernel):
//   - the grid is at least a block an SM and at most what the card holds
//     resident (occupancy × SMs), launched with cudaLaunchKernelEx and
//     cudaLaunchAttributeCooperative, which guarantees co-residency; the
//     sweeps are separated by cooperative_groups::this_grid().sync(). A
//     cooperative kernel node can be captured in a CUDA graph (CUDA 12), so
//     a call is one capturable device operation, whatever its sweep count;
//   - z lives body-major in two tables A and B [NPAD, 16] (64 B a body, its
//     12 velocity floats first: the gather of an endpoint is three 16-byte
//     loads through L2, its scatter three float4 atomicAdds, sm_90's vector
//     atomics). Sweep 0 adds into both; sweep s ≥ 1 reads one and adds into
//     the other, which lacks the previous sweep's deltas: each contact adds
//     the sum of its previous and current impulse, so the other table
//     becomes the next snapshot without a copy, and one barrier a sweep
//     suffices;
//   - sweep 0 runs over every slot of the block's share, a range of 32-slot
//     chunks in the order of a multiplicative permutation (a table's live
//     slots bunch at the front of each bucket; permuted chunks load the
//     blocks evenly), and compacts the live contacts (R_RELAX ≠ 0:
//     relaxation·actf_t, the refreshed activity on anchored paths) with a
//     block scan into the block's list; later sweeps walk that list alone.
//     A slot that is not live has no effect after sweep 0 (zero
//     relaxation, masses and warm-start impulse), so its λ is written once
//     there;
//   - each live contact's 42 sweep constants, its λ, previous impulse and
//     relaxation over the degrees (final after sweep 0, so divided once)
//     stay in the block's shared memory (55 floats: an odd stride, so a
//     warp reads without bank conflicts) for the first `scap` contacts of
//     the block; the rest are written to a constants scratch in global
//     memory and read from there by slot, with their state in a global
//     scratch. Any live count is solved. 2.6 folded into sweep 0 moves no
//     constants through global memory for a held contact (its own kernel
//     wrote 45 rows a slot, which 2.5's sweep 0 read back).
// What bounds it on the H100: the sweeps are a chain of small dependent
// steps (about 18,200 live contacts of the 4k pile: a 48-byte gather per
// endpoint, ~250 flops, 12 atomic floats per endpoint), so a later sweep
// costs its slowest block's work, about half of it atomics, plus a grid
// barrier of ~1 µs, not bytes; sweep 0 of the packed envs (196,608 slots)
// reads the contact table once. Atomic f32 sums land in a different order
// every run, so results match the plain version to a tolerance, not
// bitwise; 2.6 has no sums across contacts and matches bit for bit (an
// optional constants output of sweep 0 receives every touched slot's 45
// rows, for that check only). 2.7 is a launch a sweep
// (sharded_sweep_kernel, below the persistent solve): the same tables,
// gathers, scatters and live list, with the ranks' all-reduce of each
// sweep's delta between two launches.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

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
constexpr int kCinRows = 14;        // a contact's rows of cin (solver/banded_solve.py _cin)

// the persistent solve: a live contact's record in shared memory, rows
// 0:42 its sweep constants (R_* layout), then its λ, the impulse and Δλ_b
// of its previous sweep, its relaxation over the degrees, its slot and its
// endpoint ranks (55 floats: an odd stride)
constexpr int kSweepRows = R_LAM0;
constexpr int S_LAM = 42, S_PREV = 46, S_RELAX = 50, S_SLOT = 51, S_RANKA = 52, S_RANKB = 53;
constexpr int kRec = 55;

constexpr int FLAG_USE_SPLIT = 1, FLAG_ANCHORED = 2, FLAG_INTEGRATE = 4, FLAG_RENORM = 8;

struct Params {
  const float* table;
  const float* warm8;
  const float* geom;
  float* z;
  float* lam;
  float* consts;       // constants scratch, by slot (R_* rows)
  float* consts_out;   // 2.5, 2.7: 2.6's 45 rows of each touched slot, or null
  const float* cin;    // 2.5, 2.7: the contact rows [kCinRows, cin_ld]
  size_t cin_ld;
  float* pq;
  const float* pos0;   // rows of the pre-step pos (x, y, z) ...
  const float* quat0;  // ... and quat (w, x, y, z), row stride npad
  int cp, npad;
  float baum_over_dt, slop, relaxation, dt;
  int flags;
};

// What the persistent solve adds: 2.5's inputs, the scratch and the plan.
struct Live {
  const float* z0;    // 2.5: the velocity table at the start [16, NPAD]
  const int* bases;   // 2.5: window starts [Cp / tile] ...
  const int* la;      // ... and window-local endpoint ranks (−1: none)
  const int* lb;
  float* zt;          // [2, NPAD, 16] tables A and B
  float* st;          // [9, Cp] the state, by slot, of the live contacts
                      // held in global memory: λ, previous impulse and
                      // Δλ_b, relaxation over the degrees (S_LAM:S_SLOT)
  int* list;          // each block's live slots, at 32·cpb·block
  int tile, n_sweeps, vel_iters, pos_iters;
  int cpb;            // 32-slot chunks a block (at most)
  int deal;           // chunk x of the deal is chunk x·deal mod chunks
  int scap;           // live contacts a block holds in shared memory
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

// 2.3's constants of contact j (contacts_pallas._prep_consts_math, with the
// anchored refresh of :440-481) into c [48] and its endpoint ranks (−1:
// none), for an active slot (table activity > 0).
__device__ __forceinline__ void fused_prep(const Params& p, int j, float* c, int& rank_a, int& rank_b) {
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
  rank_a = act ? ra : -1;
  rank_b = has_b ? rb1 - 1 : -1;
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
  const float lam0[3] = {p.warm8[j], p.warm8[cp + j], p.warm8[2 * cp + j]};
  prep_consts_math(p, ga, gb, p_t, n_t, d_t, tb[7], tb[8], actf_t, lam0, has_bf, c);
  c[R_DEPTH] = (p.flags & FLAG_ANCHORED) ? d_t * actf_t : 0.f;
  c[R_RANKA] = (float)rank_a;
  c[R_RANKB] = (float)rank_b;
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

// Position integration of rank c from its final z row `own`
// (contacts_pallas.py:563-619): pos += (v + pv)·dt,
// q ← exp(ω dt) ∘ normalize(exp(pω dt) ∘ q).
__device__ __forceinline__ void integrate_rank(const Params& p, const float* own, int c) {
  const size_t np = (size_t)p.npad;
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

// 2.6 folded into sweep 0 of 2.5 and 2.7: slot j (endpoint ranks rank_a,
// rank_b; −1: none) is touched when it has an endpoint or a relaxation
// (relaxation·activity ≠ 0); a touched slot's constants, rows 0:45 of c,
// from its cin rows (point 0:3, normal 3:6, depth, friction, restitution,
// activity, λ₀ 10:13, has_b) and its endpoints' geometry, and into
// consts_out when that is given. An untouched slot changes nothing: with
// warm start its λ is λ₀·activity, as 2.6's rows 42:45 were. Returns
// whether j is touched. (The fused solve's depth and rank rows are not
// part of 2.6's output; 2.5 refuses the anchored flag that reads depth.)
__device__ __forceinline__ bool cin_consts(const Params& p, int j, int rank_a, int rank_b, float* c, float* lam) {
  const size_t ld = p.cin_ld;
  const float actf = p.cin[9 * ld + j];
  const bool touch = rank_a >= 0 || rank_b >= 0 || p.relaxation * actf != 0.f;
  if (touch) {
    float ci[kCinRows];
#pragma unroll
    for (int k = 0; k < kCinRows; ++k) ci[k] = p.cin[(size_t)k * ld + j];
    float ga[24], gb[24];
    load_solve(p.geom, p.npad, rank_a, ga);
    load_solve(p.geom, p.npad, rank_b, gb);
    prep_consts_math(p, ga, gb, mk(ci[0], ci[1], ci[2]), mk(ci[3], ci[4], ci[5]), ci[6], ci[7], ci[8], ci[9],
                     ci + 10, ci[13], c);
    if (p.consts_out != nullptr) {
#pragma unroll
      for (int k = 0; k < kPrepRows; ++k) p.consts_out[(size_t)k * p.cp + j] = c[k];
    }
  } else if (p.flags & FLAG_USE_SPLIT) {
#pragma unroll
    for (int k = 0; k < 3; ++k) lam[k] = p.cin[(size_t)(10 + k) * ld + j] * actf;
  }
  return touch;
}

// ---------------------------------------------------------------------------
// the persistent solve of 2.3 (kFused) and 2.5
// ---------------------------------------------------------------------------

// A body's row of the tables (16 floats) holds z's rows in the order
// v, ω, pseudo v, pseudo ω (12 floats a contact adds to: three 16-byte
// vectors), the degree, then z's rows 6, 7 and 15; zslot(r) is z row r's
// place.
__device__ __forceinline__ constexpr int zslot(int r) {
  return r < 6 ? r : r < 8 ? r + 7 : r < 14 ? r - 2 : r == 14 ? 12 : 15;
}

// Quarter q (floats 4q:4q+4) of body `rank`'s row of a table, through L2:
// other blocks' atomics changed it since this SM last read it (via_l1: a
// table no block of the launch writes).
__device__ __forceinline__ float4 ld4(const float* zt, int rank, int q, bool via_l1 = false) {
  const float4* p = reinterpret_cast<const float4*>(zt + (size_t)rank * kZRows) + q;
  return via_l1 ? __ldg(p) : __ldcg(p);
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// Adds to body `rank`'s row of a table: (dv, dw) when `vel`, (pdv, pdw)
// when `pseudo`, and deg to its degree.
__device__ __forceinline__ void scatter(float* zt, int rank, V3 dv, V3 dw, bool vel, V3 pdv, V3 pdw, bool pseudo,
                                        float deg) {
  float* row = zt + (size_t)rank * kZRows;
  if (vel) atomicAdd(reinterpret_cast<float4*>(row), make_float4(dv.x, dv.y, dv.z, dw.x));
  if (vel && pseudo) {
    atomicAdd(reinterpret_cast<float4*>(row + 4), make_float4(dw.y, dw.z, pdv.x, pdv.y));
  } else if (vel) {
    atomicAdd(reinterpret_cast<float2*>(row + 4), make_float2(dw.y, dw.z));
  } else if (pseudo) {
    atomicAdd(reinterpret_cast<float2*>(row + 6), make_float2(pdv.x, pdv.y));
  }
  if (pseudo) atomicAdd(reinterpret_cast<float4*>(row + 8), make_float4(pdv.z, pdw.x, pdw.y, pdw.z));
  if (deg != 0.f) atomicAdd(row + zslot(14), deg);
}

// Sweep 0 of one contact with constants c: the degree scatter and, with
// warm start, λ: 0 → λ₀ (vel_on = pos_on = 0, so nothing here reads z),
// added into zt_a and, unless it is null, zt_b. λ after the sweep → lam.
__device__ __forceinline__ void sweep0(const Params& p, const float* c, int rank_a, int rank_b, float* zt_a,
                                       float* zt_b, float* lam) {
  const bool warm = p.flags & FLAG_USE_SPLIT;
#pragma unroll
  for (int k = 0; k < 3; ++k) lam[k] = warm ? c[R_LAM0 + k] : 0.f;
  lam[3] = 0.f;
  const V3 nrm = mk(c[R_N], c[R_N + 1], c[R_N + 2]);
  const V3 t1 = mk(c[R_T1], c[R_T1 + 1], c[R_T1 + 2]);
  const V3 t2 = mk(c[R_T2], c[R_T2 + 1], c[R_T2 + 2]);
  const V3 imp = add(add(scale(nrm, lam[0]), scale(t1, lam[1])), scale(t2, lam[2]));
  const V3 z3 = mk(0.f, 0.f, 0.f);
#pragma unroll
  for (int side = 0; side < 2; ++side) {
    const int rank = side == 0 ? rank_a : rank_b;
    if (rank < 0) continue;
    const float sign = side == 0 ? 1.0f : -1.0f;
    const float inv_m = c[side == 0 ? R_IMA : R_IMB];
    const float* iw = c + (side == 0 ? R_IWA : R_IWB);
    const V3 r = side == 0 ? mk(c[R_RA], c[R_RA + 1], c[R_RA + 2]) : mk(c[R_RB], c[R_RB + 1], c[R_RB + 2]);
    const V3 dv = scale(imp, sign * inv_m);
    const V3 dw = scale(mat_vec(iw, cross(r, imp)), sign);
    scatter(zt_a, rank, dv, dw, warm, z3, z3, false, 1.0f);
    if (zt_b != nullptr) scatter(zt_b, rank, dv, dw, warm, z3, z3, false, 1.0f);
  }
}

// A later sweep of one live contact (contacts_pallas._sweep_tile_math
// without the warm and degree terms, which are 0 after sweep 0): its sweep
// constants are cr[k·cs] (shared memory: cs = 1; global: cs = Cp), its λ
// lam[k·ls]. It reads the snapshot zr, plus zd unless that is null (2.7:
// the previous sweep's summed delta, added as the grid's next table is),
// and adds its deltas into zw: with `prev` (the persistent solve, whose zw
// lacks the previous sweep's deltas) the sum of its previous impulse
// prev[k·ls] (x, y, z, Δλ_b) and the current one, which it keeps there;
// else (2.7, whose zw is a zero delta table) the current one. The degrees
// are final after sweep 0, so the first later sweep divides the
// relaxation by them once and keeps the quotient in *rel.
__device__ __forceinline__ void sweep_live(const float* cr, size_t cs, float* lam, size_t ls, float* prev,
                                           float* rel, int rank_a, int rank_b, const float* zr, const float* zd,
                                           float* zw, float vel_on, float pos_on, bool pseudo, bool first) {
  // the endpoints' rows: v, ω, pseudo v, pseudo ω; the degree (the
  // fourth quarter) only in the first later sweep
  float za[kZRows], zb[kZRows];
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const bool need = q < 3 || first;
    // 2.7 writes neither table it reads, so its reads may stay in L1
    const bool ro = zd != nullptr;
    float4 a = (need && rank_a >= 0) ? ld4(zr, rank_a, q, ro) : zero4;
    float4 b = (need && rank_b >= 0) ? ld4(zr, rank_b, q, ro) : zero4;
    if (ro) {
      a = add4(a, (need && rank_a >= 0) ? ld4(zd, rank_a, q, true) : zero4);
      b = add4(b, (need && rank_b >= 0) ? ld4(zd, rank_b, q, true) : zero4);
    }
    za[4 * q] = a.x, za[4 * q + 1] = a.y, za[4 * q + 2] = a.z, za[4 * q + 3] = a.w;
    zb[4 * q] = b.x, zb[4 * q + 1] = b.y, zb[4 * q + 2] = b.z, zb[4 * q + 3] = b.w;
  }
  auto at = [&](int row) { return cr[(size_t)row * cs]; };
  const V3 r_a = mk(at(R_RA), at(R_RA + 1), at(R_RA + 2));
  const V3 r_b = mk(at(R_RB), at(R_RB + 1), at(R_RB + 2));
  const V3 nrm = mk(at(R_N), at(R_N + 1), at(R_N + 2));
  const V3 t1 = mk(at(R_T1), at(R_T1 + 1), at(R_T1 + 2));
  const V3 t2 = mk(at(R_T2), at(R_T2 + 1), at(R_T2 + 2));
  const float inv_k_n = at(R_IKN), inv_k_t1 = at(R_IKT1), inv_k_t2 = at(R_IKT2);
  const float v_target = at(R_VTGT), bias = at(R_BIAS), friction = at(R_FRIC);
  float relax;
  if (first) {
    relax = at(R_RELAX) / fmaxf(fmaxf(za[12], zb[12]), 1.0f);
    *rel = relax;
  } else {
    relax = *rel;
  }
  const float lam_n = lam[0], lam_t1 = lam[ls], lam_t2 = lam[2 * ls], lam_b = lam[3 * ls];

  const V3 va = add(mk(za[0], za[1], za[2]), cross(mk(za[3], za[4], za[5]), r_a));
  const V3 vb = add(mk(zb[0], zb[1], zb[2]), cross(mk(zb[3], zb[4], zb[5]), r_b));
  const V3 v = sub(va, vb);
  const float v_n = dot(nrm, v);
  const float d_lam = (v_target - v_n) * inv_k_n * relax * vel_on;
  const float lam_n_new = fmaxf(lam_n + d_lam, 0.f);
  const float lim = friction * lam_n_new;
  const float v_t1 = dot(t1, v);
  const float lam_t1_new = fminf(fmaxf(lam_t1 - v_t1 * inv_k_t1 * relax * vel_on, -lim), lim);
  const float v_t2 = dot(t2, v);
  const float lam_t2_new = fminf(fmaxf(lam_t2 - v_t2 * inv_k_t2 * relax * vel_on, -lim), lim);
  const V3 pva = add(mk(za[6], za[7], za[8]), cross(mk(za[9], za[10], za[11]), r_a));
  const V3 pvb = add(mk(zb[6], zb[7], zb[8]), cross(mk(zb[9], zb[10], zb[11]), r_b));
  const float pv_n = dot(nrm, sub(pva, pvb));
  const float d_lam_b = (bias - pv_n) * inv_k_n * relax * pos_on;
  const float lam_b_new = fmaxf(lam_b + d_lam_b, 0.f);

  const V3 imp = add(add(scale(nrm, lam_n_new - lam_n), scale(t1, lam_t1_new - lam_t1)),
                     scale(t2, lam_t2_new - lam_t2));
  const float dlb = lam_b_new - lam_b;
  V3 tot = imp;
  float pdlb = dlb;
  if (prev != nullptr) {
    tot = add(imp, mk(prev[0], prev[ls], prev[2 * ls]));
    pdlb = dlb + prev[3 * ls];
    prev[0] = imp.x;
    prev[ls] = imp.y;
    prev[2 * ls] = imp.z;
    prev[3 * ls] = dlb;
  }
  const V3 ptot = scale(nrm, pdlb);
  lam[0] = lam_n_new;
  lam[ls] = lam_t1_new;
  lam[2 * ls] = lam_t2_new;
  lam[3 * ls] = lam_b_new;
#pragma unroll
  for (int side = 0; side < 2; ++side) {
    const int rank = side == 0 ? rank_a : rank_b;
    if (rank < 0) continue;
    const float sign = side == 0 ? 1.0f : -1.0f;
    const float inv_m = at(side == 0 ? R_IMA : R_IMB);
    const int iw0 = side == 0 ? R_IWA : R_IWB;
    float iw[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) iw[k] = at(iw0 + k);
    const V3 r = side == 0 ? r_a : r_b;
    const V3 dv = scale(tot, sign * inv_m);
    const V3 dw = scale(mat_vec(iw, cross(r, tot)), sign);
    const V3 pdv = scale(ptot, sign * inv_m);
    const V3 pdw = scale(mat_vec(iw, cross(r, ptot)), sign);
    scatter(zw, rank, dv, dw, true, pdv, pdw, pseudo, 0.f);
  }
}

// The whole solve in one cooperative launch: the tables, sweep 0 with the
// live lists, the later sweeps over the lists, z out and the integration,
// separated by grid barriers.
template <bool kFused>
__global__ void __launch_bounds__(kThreads, 2) solve_kernel(Params p, Live l) {
  extern __shared__ __align__(16) float rec[];   // the held contacts' records
  __shared__ int warp_sums[32];
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x;
  const int nthreads = gridDim.x * blockDim.x;
  const size_t np = (size_t)p.npad, cp = (size_t)p.cp;
  const bool anchored = p.flags & FLAG_ANCHORED;
  float* zt_a = l.zt;
  float* zt_b = l.zt + np * kZRows;

  // ---- A = B = z at the start: (v, ω) of the geometry table (2.3) or z0 ----
  for (int c = blockIdx.x * blockDim.x + tid; c < p.npad; c += nthreads) {
    float v[kZRows];
#pragma unroll
    for (int r = 0; r < kZRows; ++r)
      v[zslot(r)] = kFused ? (r < 6 ? p.geom[(size_t)(13 + r) * np + c] : 0.f) : l.z0[(size_t)r * np + c];
    float4* ra = reinterpret_cast<float4*>(zt_a + (size_t)c * kZRows);
    float4* rb = reinterpret_cast<float4*>(zt_b + (size_t)c * kZRows);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 x = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
      ra[q] = x;
      rb[q] = x;
    }
  }
  grid.sync();

  // ---- sweep 0 over every slot of the block's range; the live listed ----
  // the block's slots: 32-slot chunks g·cpb … g·cpb + cpb − 1 of the deal
  // x → x·deal mod chunks, a permutation that scatters each bucket's
  // chunks over the blocks (a contact table's live slots bunch at the
  // front of each bucket, so ranges in slot order would load the blocks
  // unevenly), a chunk a warp in each round
  const int g = blockIdx.x;
  const int n_chunks = (p.cp + 31) / 32;
  const int my_chunks = max(0, min(l.cpb, n_chunks - g * l.cpb));
  const int j0 = g * 32 * l.cpb;   // the block's region of the live list
  const int warps = blockDim.x / 32;
  int n_live = 0;
  for (int k0 = 0; k0 < my_chunks; k0 += warps) {
    const int k = k0 + tid / 32;
    const int chunk = (int)((size_t)(g * l.cpb + k) * l.deal % n_chunks);
    const int j = k < my_chunks ? chunk * 32 + (tid & 31) : p.cp;
    float c[kRConst];
    float lam[4] = {0.f, 0.f, 0.f, 0.f};
    int rank_a = -1, rank_b = -1;
    bool live = false;
    if (j < p.cp) {
      // a slot that is inactive in the table (2.3), or has no endpoint and
      // no relaxation (2.5), changes nothing: its λ is λ₀ (zero in 2.3)
      bool touch;
      if (kFused) {
        touch = p.table[9 * cp + j] > 0.f;
        if (touch) fused_prep(p, j, c, rank_a, rank_b);
      } else {
        rank_a = win_rank(l.bases, l.la, l.tile, j);
        rank_b = win_rank(l.bases, l.lb, l.tile, j);
        touch = cin_consts(p, j, rank_a, rank_b, c, lam);
      }
      if (touch) {
        sweep0(p, c, rank_a, rank_b, zt_a, zt_b, lam);
        // later sweeps change nothing without relaxation and impulse
        live = c[R_RELAX] != 0.f || lam[0] != 0.f || lam[1] != 0.f || lam[2] != 0.f;
      }
      // λ after sweep 0, final unless live; row 3 on anchored paths is the
      // refreshed depth·activity
      p.lam[j] = lam[0];
      p.lam[cp + j] = lam[1];
      p.lam[2 * cp + j] = lam[2];
      p.lam[3 * cp + j] = (anchored && touch) ? c[R_DEPTH] : lam[3];
    }
    int total;
    const int off = block_exclusive_scan(live ? 1 : 0, warp_sums, total);
    if (live) {
      const int e = n_live + off;
      l.list[j0 + e] = j;
      if (e < l.scap) {
        float* r = rec + (size_t)e * kRec;
#pragma unroll
        for (int k = 0; k < kSweepRows; ++k) r[k] = c[k];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          r[S_LAM + k] = lam[k];
          r[S_PREV + k] = 0.f;
        }
        r[S_SLOT] = __int_as_float(j);
        r[S_RANKA] = __int_as_float(rank_a);
        r[S_RANKB] = __int_as_float(rank_b);
      } else {
#pragma unroll
        for (int k = 0; k < kSweepRows; ++k) p.consts[k * cp + j] = c[k];
        if (kFused) {
          p.consts[R_RANKA * cp + j] = (float)rank_a;
          p.consts[R_RANKB * cp + j] = (float)rank_b;
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          l.st[k * cp + j] = lam[k];
          l.st[(4 + k) * cp + j] = 0.f;
        }
      }
    }
    n_live += total;
  }
  grid.sync();

  // ---- sweeps 1 … S−1 over the live list: read zr, add into zw ----
  const float* zr = zt_a;
  float* zw = zt_b;
  const bool pseudo = l.pos_iters > 0;
  for (int s = 1; s < l.n_sweeps; ++s) {
    const int i = s - 1;
    const float vel_on = i < l.vel_iters ? 1.0f : 0.0f;
    const float pos_on = i < l.pos_iters ? 1.0f : 0.0f;
    const bool last = s == l.n_sweeps - 1;
    for (int e = tid; e < n_live; e += blockDim.x) {
      int j, rank_a, rank_b;
      const float* cr;
      float* sr;
      size_t cs, ss;
      if (e < l.scap) {
        float* r = rec + (size_t)e * kRec;
        j = __float_as_int(r[S_SLOT]);
        rank_a = __float_as_int(r[S_RANKA]);
        rank_b = __float_as_int(r[S_RANKB]);
        cr = r;
        sr = r + S_LAM;
        cs = ss = 1;
      } else {
        j = l.list[j0 + e];
        if (kFused) {
          rank_a = (int)p.consts[R_RANKA * cp + j];
          rank_b = (int)p.consts[R_RANKB * cp + j];
        } else {
          rank_a = win_rank(l.bases, l.la, l.tile, j);
          rank_b = win_rank(l.bases, l.lb, l.tile, j);
        }
        cr = p.consts + j;
        sr = l.st + j;
        cs = ss = cp;
      }
      sweep_live(cr, cs, sr, ss, sr + 4 * ss, sr + 8 * ss, rank_a, rank_b, zr, nullptr, zw, vel_on, pos_on, pseudo,
                 s == 1);
      if (last) {
        p.lam[j] = sr[0];
        p.lam[cp + j] = sr[ss];
        p.lam[2 * cp + j] = sr[2 * ss];
        if (!anchored) p.lam[3 * cp + j] = sr[3 * ss];
      }
    }
    grid.sync();
    float* t = const_cast<float*>(zr);
    zr = zw;
    zw = t;
  }

  // ---- z out [16, NPAD] and the integration, from the final table ----
  for (int c = blockIdx.x * blockDim.x + tid; c < p.npad; c += nthreads) {
    float row[kZRows], own[kZRows];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 x = ld4(zr, c, q);
      row[4 * q] = x.x, row[4 * q + 1] = x.y, row[4 * q + 2] = x.z, row[4 * q + 3] = x.w;
    }
#pragma unroll
    for (int r = 0; r < kZRows; ++r) {
      own[r] = row[zslot(r)];
      p.z[(size_t)r * np + c] = own[r];
    }
    if (p.flags & FLAG_INTEGRATE) integrate_rank(p, own, c);
  }
}

// The persistent grid: blocks of kThreads, at least one an SM and as many
// as the card holds resident with two blocks an SM's shared memory each
// (a block a kThreads slots in between), each block `cpb` 32-slot chunks
// at most and shared memory for `scap` live contacts.
struct Plan {
  int grid, cpb, scap, per_sm, deal;
  size_t smem;
};

constexpr int kMaxDevices = 64;

template <bool kFused>
cudaError_t solve_plan(int cp, Plan& pl) {
  // per device, once: the attribute and occupancy queries are not stream
  // work, and a call that a CUDA graph captures makes none after the first
  static int sms[kMaxDevices], budget[kMaxDevices], per_sm[kMaxDevices];
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (per_sm[dev] == 0) {
    int smem_sm = 0, optin = 0;
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&smem_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
    // two blocks an SM, each with the 1 KB the card reserves a block and
    // its static shared memory
    int b = smem_sm / 2 - 1024 - 256;
    b = b < optin ? b : optin;
    err = cudaFuncSetAttribute(solve_kernel<kFused>, cudaFuncAttributeMaxDynamicSharedMemorySize, b);
    int occ = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, solve_kernel<kFused>, kThreads, (size_t)b);
    if (err != cudaSuccess) return err;
    if (occ < 1) return cudaErrorCooperativeLaunchTooLarge;
    budget[dev] = b;
    per_sm[dev] = occ;
  }
  const int gmax = sms[dev] * per_sm[dev];
  const int by_slots = (cp + kThreads - 1) / kThreads;
  const int want = by_slots > sms[dev] ? by_slots : sms[dev];
  pl.per_sm = per_sm[dev];
  pl.grid = want < gmax ? (want > 0 ? want : 1) : gmax;
  const int n_chunks = (cp + 31) / 32;
  pl.cpb = (n_chunks + pl.grid - 1) / pl.grid;
  const int cap = budget[dev] / (kRec * 4);
  pl.scap = 32 * pl.cpb < cap ? 32 * pl.cpb : cap;
  pl.smem = (size_t)pl.scap * kRec * 4;
  // the deal: a multiplier near the golden ratio of the chunk count,
  // coprime to it (a bijection of the chunks)
  int deal = (int)(0.6180339887 * n_chunks) | 1;
  auto gcd = [](int a, int b) {
    while (b) {
      const int t = a % b;
      a = b;
      b = t;
    }
    return a;
  };
  while (deal > 1 && gcd(deal, n_chunks) != 1) deal += 2;
  pl.deal = n_chunks > 1 ? deal % n_chunks : 0;
  return cudaSuccess;
}

template <bool kFused>
cudaError_t launch_solve(const Params& p, Live l, int list_len, cudaStream_t stream) {
  Plan pl;
  cudaError_t err = solve_plan<kFused>(p.cp, pl);
  if (err != cudaSuccess) return err;
  if ((size_t)pl.grid * 32 * pl.cpb > (size_t)list_len) return cudaErrorInvalidValue;
  l.cpb = pl.cpb;
  l.scap = pl.scap;
  l.deal = pl.deal;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(pl.grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = pl.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, solve_kernel<kFused>, p, l);
}

// 2.7 (banded_sweep_once, contacts_pallas.py:956; body _make_sweep1_kernel
// :914): one sweep of a rank's contact tiles for the row-sharded solve, a
// launch a sweep. Between two launches the ranks all-reduce the sweep's
// delta table; each launch folds the previous summed delta into the next
// snapshot table itself. Tables body-major [NPAD, 16] (zslot): two snapshot
// tables Z, three delta tables D. Sweep s adds into D[s % 3], reads Z[(s −
// 1) % 2] + D[(s − 1) % 3] for its gathers, writes that sum, computed by the
// same f32 add, to Z[s % 2] and zeroes D[(s + 1) % 3], which sweep s − 2
// filled and sweep s − 1 folded in. Every rank applies the same adds to the
// same summed bits, so the ranks' z stay bitwise equal; the caller zeroes D
// and the live count once a solve. Sweep 0 writes Z[0] from z0 and runs
// over every slot of the rank: 2.6's constants of the touched ones (from
// the rank's columns of cin, read in place: no slice copy), the degrees,
// the warm start and λ of each, and the live ones (relaxation or impulse;
// a slot that has neither adds exact zeros in every later sweep)
// compacted into the list, a block scan and one atomic offset a block,
// their sweep constants kept in the rank's constants scratch. The later
// sweeps run on the same grid over the list's first *count entries (read
// on the card: no host round trip), their constants read from that
// scratch by slot, λ updated in place by slot, the endpoint ranks and the
// relaxation over the degrees kept by list entry.
struct Sharded {
  const float* z0;      // [16, NPAD] z at the start (sweep 0)
  const int* bases;     // window starts [Cp / tile] ...
  const int* la;        // ... and window-local endpoint ranks (−1: none)
  const int* lb;
  float* zt;            // [2, NPAD, 16] snapshot tables
  float* dz;            // [3, NPAD, 16] delta tables
  int* list;            // [Cp] the live slots ...
  int* count;           // ... and how many
  int* ends;            // [2, Cp] endpoint ranks (−1: none), by list entry
  float* relax;         // [Cp] relaxation over the degrees, by list entry
  int tile, sweep;
  float vel_on, pos_on;
};

// 2.7's blocks: of 32 to 128 threads, as few as spread a rank's slots over
// every SM (a later sweep is a chain of dependent loads a contact; more
// SMs, more of them in flight)
constexpr int kShardThreads = 128;

__global__ void __launch_bounds__(kShardThreads) sharded_sweep_kernel(Params p, Sharded h) {
  __shared__ int warp_sums[32];
  __shared__ int block_off;
  const int tid = threadIdx.x;
  const int t0 = blockIdx.x * blockDim.x + tid;
  const int nthreads = gridDim.x * blockDim.x;
  const size_t np = (size_t)p.npad, cp = (size_t)p.cp;
  const size_t tbl = np * kZRows;
  const int s = h.sweep;
  float* zw = h.dz + (size_t)(s % 3) * tbl;

  if (s == 0) {
    float* z_a = h.zt;
    for (int c = t0; c < p.npad; c += nthreads) {
      float v[kZRows];
#pragma unroll
      for (int r = 0; r < kZRows; ++r) v[zslot(r)] = h.z0[(size_t)r * np + c];
      float4* row = reinterpret_cast<float4*>(z_a + (size_t)c * kZRows);
#pragma unroll
      for (int q = 0; q < 4; ++q) row[q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
    }
    const int j = t0;
    bool live = false;
    if (j < p.cp) {
      float c[kRConst];
      float lam[4] = {0.f, 0.f, 0.f, 0.f};
      const int rank_a = win_rank(h.bases, h.la, h.tile, j);
      const int rank_b = win_rank(h.bases, h.lb, h.tile, j);
      if (cin_consts(p, j, rank_a, rank_b, c, lam)) {
        sweep0(p, c, rank_a, rank_b, zw, nullptr, lam);
        live = c[R_RELAX] != 0.f || lam[0] != 0.f || lam[1] != 0.f || lam[2] != 0.f;
        if (live) {
#pragma unroll
          for (int k = 0; k < kSweepRows; ++k) p.consts[k * cp + j] = c[k];
        }
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) p.lam[k * cp + j] = lam[k];
    }
    int total;
    const int off = block_exclusive_scan(live ? 1 : 0, warp_sums, total);
    if (tid == 0) block_off = total ? atomicAdd(h.count, total) : 0;
    __syncthreads();
    const int e = block_off + off;
    if (live && e < p.cp) {  // (a scratch used twice: never past the list)
      h.list[e] = j;
      h.ends[e] = win_rank(h.bases, h.la, h.tile, j);
      h.ends[cp + e] = win_rank(h.bases, h.lb, h.tile, j);
    }
    return;
  }

  // ---- a later sweep: the next snapshot table, the delta table after ----
  const float* zr = h.zt + (size_t)((s - 1) % 2) * tbl;
  const float* zd = h.dz + (size_t)((s - 1) % 3) * tbl;
  float4* z_next = reinterpret_cast<float4*>(h.zt + (size_t)(s % 2) * tbl);
  float4* d_next = reinterpret_cast<float4*>(h.dz + (size_t)((s + 1) % 3) * tbl);
  for (int q = t0; q < p.npad * 4; q += nthreads) {
    z_next[q] = add4(__ldcg(reinterpret_cast<const float4*>(zr) + q), __ldcg(reinterpret_cast<const float4*>(zd) + q));
    d_next[q] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const int n_live = min(*h.count, p.cp);
  const bool pseudo = h.pos_on != 0.f;
  for (int e = t0; e < n_live; e += nthreads) {
    const int j = h.list[e];
    sweep_live(p.consts + j, cp, p.lam + j, cp, nullptr, h.relax + e, h.ends[e], h.ends[cp + e], zr, zd, zw,
               h.vel_on, h.pos_on, pseudo, s == 1);
  }
}

}  // namespace

extern "C" int bs_banded_solve(const float* table, const float* warm8, const float* geom, float* z_out,
                               float* lam_out, float* pq_out, float* consts, float* zt, float* st, int* list,
                               int list_len, int cp, int npad, int trows, int n_sweeps, int vel_iters, int pos_iters,
                               float baum_over_dt, float slop, float relaxation, float dt, int flags,
                               void* stream_ptr) {
  const bool anchored = flags & FLAG_ANCHORED;
  if (cp < 1 || n_sweeps < 1 || trows < (anchored ? 25 : 16) || ((flags & FLAG_INTEGRATE) && pq_out == nullptr))
    return (int)cudaErrorInvalidValue;
  Params p = {};
  p.table = table;
  p.warm8 = warm8;
  p.geom = geom;
  p.z = z_out;
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
  Live l = {};
  l.zt = zt;
  l.st = st;
  l.list = list;
  l.n_sweeps = n_sweeps;
  l.vel_iters = vel_iters;
  l.pos_iters = pos_iters;
  const cudaError_t err = launch_solve<true>(p, l, list_len, (cudaStream_t)stream_ptr);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// 2.6 + 2.5: geom [48, npad] (solve rows 0:24 read), cin [14, cp] the
// contact rows, consts [42, cp] the scratch of the contacts a block cannot
// hold, consts_out [45, cp] 2.6's rows of each touched slot (or null).
extern "C" int bs_banded_sweeps(const float* z0, const int* bases, const int* la, const int* lb, const float* geom,
                                const float* cin, float* consts, float* consts_out, const float* posq, float* z_out,
                                float* lam_out, float* pq_out, float* zt, float* st, int* list, int list_len, int cp,
                                int npad, int tile, int n_sweeps, int vel_iters, int pos_iters, float baum_over_dt,
                                float slop, float relaxation, float dt, int flags, void* stream_ptr) {
  const bool integrate = flags & FLAG_INTEGRATE;
  if (cp < 1 || tile < 1 || cp % tile || n_sweeps < 1 || (flags & FLAG_ANCHORED) ||
      (integrate && (pq_out == nullptr || posq == nullptr)))
    return (int)cudaErrorInvalidValue;
  Params p = {};
  p.geom = geom;
  p.cin = cin;
  p.cin_ld = (size_t)cp;
  p.z = z_out;
  p.lam = lam_out;
  p.consts = consts;
  p.consts_out = consts_out;
  p.baum_over_dt = baum_over_dt;
  p.slop = slop;
  p.relaxation = relaxation;
  p.pq = pq_out;
  p.pos0 = posq;
  p.quat0 = posq + 3 * (size_t)npad;
  p.cp = cp;
  p.npad = npad;
  p.dt = dt;
  p.flags = flags;
  Live l = {};
  l.z0 = z0;
  l.bases = bases;
  l.la = la;
  l.lb = lb;
  l.zt = zt;
  l.st = st;
  l.list = list;
  l.tile = tile;
  l.n_sweeps = n_sweeps;
  l.vel_iters = vel_iters;
  l.pos_iters = pos_iters;
  const cudaError_t err = launch_solve<false>(p, l, list_len, (cudaStream_t)stream_ptr);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// The persistent solve's plan for a table of cp slots (fused: 2.3, else
// 2.5) and its kernel's resources: out = {grid, slots a block (at most),
// live contacts a block holds in shared memory, its bytes, blocks an SM,
// registers a thread, local (spill) bytes a thread}.
extern "C" int bs_solve_plan(int fused, int cp, int* out) {
  Plan pl;
  cudaFuncAttributes fa;
  cudaError_t err = fused ? solve_plan<true>(cp, pl) : solve_plan<false>(cp, pl);
  if (err == cudaSuccess) err = fused ? cudaFuncGetAttributes(&fa, solve_kernel<true>)
                                      : cudaFuncGetAttributes(&fa, solve_kernel<false>);
  if (err != cudaSuccess) return (int)err;
  out[0] = pl.grid;
  out[1] = 32 * pl.cpb;
  out[2] = pl.scap;
  out[3] = (int)pl.smem;
  out[4] = pl.per_sm;
  out[5] = fa.numRegs;
  out[6] = (int)fa.localSizeBytes;
  return 0;
}

// 2.7, sweep `sweep` of a rank's sharded solve (see sharded_sweep_kernel):
// geom [48, npad] and the rank's contact rows cin [14, cp] with row stride
// cin_ld (sweep 0), consts [42, cp] the sweep constants by slot (written by
// sweep 0), consts_out [45, cp] 2.6's rows of each touched slot (sweep 0;
// or null), lam [4, cp] (written by sweep 0, updated in place), the tables
// zt [2, NPAD, 16] and dz [3, NPAD, 16] (dz and *count zero before sweep
// 0), list and relax [cp], ends [2, cp]. warm (sweep 0) applies λ₀ and
// the split impulses' velocity target.
extern "C" int bs_sharded_sweep(const float* z0, const int* bases, const int* la, const int* lb, const float* geom,
                                const float* cin, int cin_ld, float* consts, float* consts_out, float* lam, float* zt,
                                float* dz, int* list, int* count, int* ends, float* relax, int cp, int npad, int tile,
                                int sweep, float vel_on, float pos_on, float baum_over_dt, float slop,
                                float relaxation, int warm, void* stream_ptr) {
  if (cp < 1 || tile < 1 || cp % tile || sweep < 0 || cin_ld < cp || (((uintptr_t)zt | (uintptr_t)dz) & 15))
    return (int)cudaErrorInvalidValue;
  Params p = {};
  p.geom = geom;
  p.cin = cin;
  p.cin_ld = (size_t)cin_ld;
  p.lam = lam;
  p.consts = consts;
  p.consts_out = consts_out;
  p.cp = cp;
  p.npad = npad;
  p.baum_over_dt = baum_over_dt;
  p.slop = slop;
  p.relaxation = relaxation;
  p.flags = warm ? FLAG_USE_SPLIT : 0;
  Sharded h = {};
  h.z0 = z0;
  h.bases = bases;
  h.la = la;
  h.lb = lb;
  h.zt = zt;
  h.dz = dz;
  h.list = list;
  h.count = count;
  h.ends = ends;
  h.relax = relax;
  h.tile = tile;
  h.sweep = sweep;
  h.vel_on = vel_on;
  h.pos_on = pos_on;
  static int sms[kMaxDevices];  // per device, once (no stream work: capturable)
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && dev >= kMaxDevices) err = cudaErrorInvalidDevice;
  if (err == cudaSuccess && sms[dev] == 0)
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int per_sm = (cp + sms[dev] - 1) / sms[dev];
  const int threads = min(kShardThreads, max(32, (per_sm + 31) / 32 * 32));
  sharded_sweep_kernel<<<(cp + threads - 1) / threads, threads, 0, (cudaStream_t)stream_ptr>>>(p, h);
  return (int)cudaGetLastError();
}
