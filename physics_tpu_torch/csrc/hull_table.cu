// Fused bucket-aligned HULL contact table (Hopper, sm_90a).
//
// Replaces the TPU kernel bucket_hull_contact_table
// (physics_tpu/ops/hull_table.py:1092, call :1218, body _make_hull_kernel
// :373-1084). Plain version: bucket_hull_contact_table_plain in
// physics_tpu_torch/ops/hull_table.py; the device code below computes the
// same operations in the same order (built with -fmad=false), so the two
// agree bit for bit.
//
// Three launches on the caller's stream:
//   1. prefilter (one block per bucket of 128 ranks): the OBB face-axis test
//      over the bucket's `cap` candidate lanes; survivors compacted, order
//      preserved, into `cap2` lanes with the stable block scan (common.cuh);
//   2. SAT (one thread per surviving lane, 64-lane blocks over a
//      (lane chunk, bucket) grid): the linear hull-hull SAT of the lane's
//      ordered type pair — every face / edge separation a 16-term dot of a
//      coefficient row (read from global memory: warp-uniform, L2-resident)
//      with m_ext = [R_aᵀR_b | dpa | dpb | 1], min-reduced over the vertex
//      rows — then the axis choice, the incident face, the reference-face
//      clip, the edge-edge closest point and the kk deepest slots, written
//      to a per-emission scratch record;
//   3. emit (one block per bucket): the kg lowest hull vertices of each of
//      the bucket's ranks, the stable block scan over all emissions in the
//      reference's order (pick-major over the lanes, then pick-major over the
//      ranks) into ccap slots, the table rows with body-frame anchors, the
//      meta counters and the warm match within the bucket.
// The TPU kernel's H² masked passes become one pass per lane with the
// lane's own coefficient slice; its one-hot selection matmuls become
// indexed reads.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kBlock = 128;        // ranks per bucket
constexpr int kE = 4;              // vertices per face polygon (clip slots 2E)
constexpr int kSl = 2 * kE;        // clip slots
constexpr int kNs = kSl + 1;       // contact slots incl. the edge-edge one
constexpr int kSatThreads = 64;
constexpr int kThreads = 256;
constexpr float kBig = 1e30f;
constexpr int kGeomRow0 = 24;      // narrow-phase block of the unified table

struct Dims {
  int nb, cap, cap2, sat_cap, ccap, kk, kg, npad, rows, h;
  int bucket0;  // the range's first bucket: bucket b of a launch starts at rank (bucket0 + b)·128
  int fp, vcap, d2, d2p, e2p;
  int r16, r32, rcb;   // rows of c16 / c32 / cb per type pair
  float gh;
};

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

// A coefficient row dotted with m_ext, summed left to right (_lin16).
__device__ __forceinline__ float dot16(const float* __restrict__ row, const float (&m)[16]) {
  const float4* r4 = reinterpret_cast<const float4*>(row);
  const float4 a = __ldg(r4), b = __ldg(r4 + 1), c = __ldg(r4 + 2), d = __ldg(r4 + 3);
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

// 9 coefficients at stride `stride` dotted with M, left to right (_lin9).
__device__ __forceinline__ float dot9(const float* __restrict__ c, size_t stride, const float (&m9)[9]) {
  float s = __ldg(c) * m9[0];
#pragma unroll
  for (int k = 1; k < 9; ++k) s = s + __ldg(c + k * stride) * m9[k];
  return s;
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
// 2. hull-hull SAT, clip, edge-edge point and top-k per lane
// ---------------------------------------------------------------------------

// Emission record of the pair phase: em_f rows 0:3 point, 3:6 normal,
// 6 depth, 7 slot id; em_i the activity flag. Index (b·kk + pick)·sat_cap + lane.
__device__ __forceinline__ void write_inactive(int* em_i, size_t e0, int kk, int sat_cap) {
  for (int pick = 0; pick < kk; ++pick) em_i[e0 + (size_t)pick * sat_cap] = 0;
}

__global__ void __launch_bounds__(kSatThreads)
hull_sat_kernel(const float* __restrict__ geom, const int* __restrict__ lanes, const float* __restrict__ c16_all,
                const float* __restrict__ c32_all, const float* __restrict__ c88_all,
                const float* __restrict__ c80_all, const float* __restrict__ cb_all,
                const int* __restrict__ eidx_all, float* __restrict__ em_f, int* __restrict__ em_i, Dims d) {
  const int b = blockIdx.y;
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= d.sat_cap) return;
  const int start = (d.bucket0 + b) * kBlock;
  const size_t n_em = (size_t)d.nb * d.kk * d.sat_cap;
  const size_t e0 = (size_t)b * d.kk * d.sat_cap + lane;
  const int la = lanes[(size_t)b * d.sat_cap + lane];
  const int lb = lanes[((size_t)d.nb + b) * d.sat_cap + lane];
  if (la < 0) {
    write_inactive(em_i, e0, d.kk, d.sat_cap);
    return;
  }
  const Hull ga = load_hull(geom, d.npad, start + la);
  const Hull gb = lb >= 0 ? load_hull(geom, d.npad, start + lb) : zero_hull();
  const bool valid = ((ga.movable > 0.f) || (gb.movable > 0.f)) && (ga.typ > 0.f) && (gb.typ > 0.f);
  const int ta = (int)(ga.typ - 1.f), tb = (int)(gb.typ - 1.f);
  if (!valid || ta >= d.h || tb >= d.h) {
    write_inactive(em_i, e0, d.kk, d.sat_cap);
    return;
  }
  const int p = ta * d.h + tb;
  const int fp = d.fp, vcap = d.vcap, d2p = d.d2p, e2p = d.e2p;
  const float* c16 = c16_all + (size_t)p * d.r16 * 16;
  const float* c32 = c32_all + (size_t)p * d.r32 * fp;
  const float* c88 = c88_all + (size_t)p * 18 * vcap * d2p;
  const float* c80 = c80_all + (size_t)p * 16 * e2p;
  const float* cb = cb_all + (size_t)p * d.rcb;
  const int* eidx = eidx_all + (size_t)p * 4 * e2p;
  const int a_face = 0, b_face = vcap * fp, lax = 2 * vcap * fp;
  const int eav = lax + 3 * d2p, ebv = eav + vcap * d2p;
  const int inc_ra = 0, inc_rb = 9 * fp, poly_a = 18 * fp, poly_b = poly_a + 3 * kE;
  const int fcnt_a = poly_b + 3 * kE, fcnt_b = fcnt_a + 1, fn_a = fcnt_b + 1, fn_b = fn_a + 3;
  const int off_a = fn_b + 3, off_b = off_a + 1;
  const int fb_a = 0, fb_b = fp, eb_a = 2 * fp, eb_b = 2 * fp + e2p;

  // ---- m_ext = [M = RaᵀRb | dpa | dpb | 1] ----
  const float* ra = ga.r;
  const float* rb = gb.r;
  float mext[16];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) mext[3 * i + j] = ra[i] * rb[j] + ra[3 + i] * rb[3 + j] + ra[6 + i] * rb[6 + j];
  const V3 dp = sub(gb.p, ga.p);
  float dpa[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    dpa[i] = ra[i] * dp.x + ra[3 + i] * dp.y + ra[6 + i] * dp.z;
    mext[9 + i] = dpa[i];
    mext[12 + i] = -(rb[i] * dp.x + rb[3 + i] * dp.y + rb[6 + i] * dp.z);
  }
  mext[15] = 1.f;
  float m9[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) m9[k] = mext[k];

  // ---- face separations: best over A's then B's faces ----
  float face_sep = 0.f;
  int face_idx = 0;
  for (int side = 0; side < 2; ++side) {
    const float* blk = c16 + (size_t)(side ? b_face : a_face) * 16;
    for (int f = 0; f < fp; ++f) {
      float s = dot16(blk + (size_t)f * 16, mext);
#pragma unroll 4
      for (int v = 1; v < vcap; ++v) s = fminf(s, dot16(blk + ((size_t)v * fp + f) * 16, mext));
      const int idx = side * fp + f;
      if (idx == 0 || s > face_sep) {
        face_sep = s;
        face_idx = idx;
      }
    }
  }

  // ---- edge axes: best over the real D² direction pairs ----
  float edge_sep = 0.f;
  int edge_idx = 0;
  for (int a = 0; a < d.d2; ++a) {
    const float ax0 = dot16(c16 + (size_t)(lax + a) * 16, mext);
    const float ax1 = dot16(c16 + (size_t)(lax + d2p + a) * 16, mext);
    const float ax2 = dot16(c16 + (size_t)(lax + 2 * d2p + a) * 16, mext);
    const float alen = sqrtf(fmaxf(ax0 * ax0 + ax1 * ax1 + ax2 * ax2, 1e-18f));
    float se = -kBig;
    if (alen > 1e-6f) {
      const float t_ax = -(ax0 * dpa[0] + ax1 * dpa[1] + ax2 * dpa[2]);
      const float* ra_rows = c16 + (size_t)(eav + a) * 16;
      const float* rb_rows = c16 + (size_t)(ebv + a) * 16;
      float min_a = dot16(ra_rows, mext), max_a = min_a;
      float min_b = dot16(rb_rows, mext), max_b = min_b;
#pragma unroll 4
      for (int v = 1; v < vcap; ++v) {
        const float sa = dot16(ra_rows + (size_t)v * d2p * 16, mext);
        const float sb = dot16(rb_rows + (size_t)v * d2p * 16, mext);
        min_a = fminf(min_a, sa);
        max_a = fmaxf(max_a, sa);
        min_b = fminf(min_b, sb);
        max_b = fmaxf(max_b, sb);
      }
      const float num = t_ax < 0.f ? min_b - max_a - t_ax : min_a - max_b + t_ax;
      se = num / alen;
    }
    if (a == 0 || se > edge_sep) {
      edge_sep = se;
      edge_idx = a;
    }
  }

  const bool separated = fmaxf(face_sep, edge_sep) > 0.f;
  const bool edge_wins = !separated && (edge_sep > face_sep + 1e-4f + 0.05f * fabsf(face_sep));
  const bool ref_is_a = face_idx < fp;
  const int fr = ref_is_a ? face_idx : face_idx - fp;

  // ---- incident face: most anti-parallel face of the other hull ----
  const int inc_base = ref_is_a ? inc_ra : inc_rb;
  const int inc_bias = ref_is_a ? fb_b : fb_a;
  float inc_best = 0.f;
  int fi = 0;
  for (int o = 0; o < fp; ++o) {
    const float al = dot9(c32 + (size_t)(inc_base + o) * fp + fr, (size_t)fp * fp, m9);
    const float val = -(al + __ldg(cb + inc_bias + o));
    if (o == 0 || val > inc_best) {
      inc_best = val;
      fi = o;
    }
  }

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
  V3 ref_w[kE], inc_w[kE];
#pragma unroll
  for (int k = 0; k < kE; ++k) {
    const float* pr = c32 + (size_t)(poly_r + k) * fp + fr;
    const float* pi = c32 + (size_t)(poly_i + k) * fp + fi;
    const float x = __ldg(pr), y = __ldg(pr + (size_t)kE * fp), z = __ldg(pr + (size_t)2 * kE * fp);
    ref_w[k] = mk(r_ref[0] * x + r_ref[1] * y + r_ref[2] * z + p_ref.x,
                  r_ref[3] * x + r_ref[4] * y + r_ref[5] * z + p_ref.y,
                  r_ref[6] * x + r_ref[7] * y + r_ref[8] * z + p_ref.z);
    const float xi = __ldg(pi), yi = __ldg(pi + (size_t)kE * fp), zi = __ldg(pi + (size_t)2 * kE * fp);
    inc_w[k] = mk(r_inc[0] * xi + r_inc[1] * yi + r_inc[2] * zi + p_inc.x,
                  r_inc[3] * xi + r_inc[4] * yi + r_inc[5] * zi + p_inc.y,
                  r_inc[6] * xi + r_inc[7] * yi + r_inc[8] * zi + p_inc.z);
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
  float ru[kE], rv[kE];
#pragma unroll
  for (int k = 0; k < kE; ++k) {
    const V3 rel = sub(ref_w[k], p0);
    ru[k] = dot(rel, t1);
    rv[k] = dot(rel, t2);
  }
  float pu[kSl], pv[kSl], ps[kSl];
#pragma unroll
  for (int k = 0; k < kE; ++k) {
    const V3 rel = sub(inc_w[k], p0);
    pu[k] = dot(rel, t1);
    pv[k] = dot(rel, t2);
    ps[k] = dot(inc_w[k], n_ref) - off_ref;
    pu[kE + k] = pv[kE + k] = ps[kE + k] = 0.f;
  }
  int m = inc_cnt;
#pragma unroll
  for (int k = 0; k < kE; ++k) {
    float ru_n = ru[0], rv_n = rv[0];
    if (k + 1 < kE) {
      const bool wrapped = (k + 1) == ref_cnt;
      ru_n = wrapped ? ru[0] : ru[k + 1];
      rv_n = wrapped ? rv[0] : rv[k + 1];
    }
    const float e_u = ru_n - ru[k];
    const float e_v = rv_n - rv[k];
    const float on = k < ref_cnt ? 1.f : 0.f;
    clip(pu, pv, ps, m, e_v * on, -e_u * on, (e_v * ru[k] - e_u * rv[k]) * on + (1.f - on) * kBig);
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
  // support of vertex u on the chosen axis (SAV / SBV rows), 0 for no edge
  auto support = [&](int base, int u) -> float {
    if (u < 0) return 0.f;
    return dot9(c88 + (size_t)(base + u) * d2p + ae, (size_t)vcap * d2p, m9) * sgn;
  };
  float best_a = 0.f, best_b = 0.f;
  int ea = 0, eb = 0;
  for (int ed = 0; ed < e2p; ++ed) {
    const float sa = -(fmaxf(support(0, __ldg(eidx + ed)), support(0, __ldg(eidx + e2p + ed))) +
                       __ldg(cb + eb_a + ed));
    const float sb = fminf(support(9 * vcap, __ldg(eidx + 2 * e2p + ed)),
                           support(9 * vcap, __ldg(eidx + 3 * e2p + ed))) -
                     __ldg(cb + eb_b + ed);
    if (ed == 0 || sa > best_a) {
      best_a = sa;
      ea = ed;
    }
    if (ed == 0 || sb > best_b) {
      best_b = sb;
      eb = ed;
    }
  }
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
  float score[kNs];
#pragma unroll
  for (int s = 0; s < kSl; ++s) score[s] = ((s < m) && (-ps[s] > 0.f) && face_ok) ? -ps[s] : -kBig;
  score[kSl] = (edge_wins && (edge_depth > 0.f)) ? edge_depth : -kBig;
  float pu_r[kNs], pv_r[kNs], ps_r[kNs];
#pragma unroll
  for (int s = 0; s < kSl; ++s) {
    pu_r[s] = pu[s];
    pv_r[s] = pv[s];
    ps_r[s] = ps[s];
  }
  pu_r[kSl] = pv_r[kSl] = ps_r[kSl] = 0.f;
  for (int pick = 0; pick < d.kk; ++pick) {
    float best;
    int bidx;
    argmax(score, best, bidx);
    const bool act = best > 0.f;
    const bool is_edge = bidx == kSl;
    const float u = select(bidx, pu_r), v = select(bidx, pv_r), s = select(bidx, ps_r);
    const V3 face_pt = mk(p0.x + u * t1.x + v * t2.x + s * n_ref.x, p0.y + u * t1.y + v * t2.y + s * n_ref.y,
                          p0.z + u * t1.z + v * t2.z + s * n_ref.z);
    const V3 pt = vsel(is_edge, edge_point, face_pt);
    const V3 nrm = vsel(is_edge, n_edge, n_face);
    const size_t e = e0 + (size_t)pick * d.sat_cap;
    em_i[e] = act ? 1 : 0;
    em_f[e] = pt.x;
    em_f[n_em + e] = pt.y;
    em_f[2 * n_em + e] = pt.z;
    em_f[3 * n_em + e] = nrm.x;
    em_f[4 * n_em + e] = nrm.y;
    em_f[5 * n_em + e] = nrm.z;
    em_f[6 * n_em + e] = act ? best : 0.f;
    em_f[7 * n_em + e] = (float)bidx;
#pragma unroll
    for (int k = 0; k < kNs; ++k) score[k] = bidx == k ? -kBig : score[k];
  }
}

// ---------------------------------------------------------------------------
// 3. ground vertices, compaction, table rows, meta, warm match
// ---------------------------------------------------------------------------

struct Smem {
  int* slot;     // [e_tot] activity flag, then slot (or -1)
  float* gnd;    // [8 · kg · 128] ground emissions: pt xyz, local vertex xyz, depth, vertex id
  float* ck;     // [ccap]
  float* ch;     // [ccap]
  float* prev;   // [5 · ccap]: ck, KH, λ0 xyz of the previous table
  int* warp_sums;// [32]
};

__host__ __device__ inline size_t emit_smem_bytes(int e_tot, int n_gnd, int ccap, bool warm) {
  return 4 * ((size_t)e_tot + 8 * (size_t)n_gnd + 2 * (size_t)ccap + (warm ? 5 * (size_t)ccap : 0) + 32);
}

__device__ Smem carve(char* base, int e_tot, int n_gnd, int ccap, bool warm) {
  Smem s;
  s.slot = reinterpret_cast<int*>(base);
  s.gnd = reinterpret_cast<float*>(s.slot + e_tot);
  s.ck = s.gnd + 8 * (size_t)n_gnd;
  s.ch = s.ck + ccap;
  s.prev = s.ch + ccap;
  s.warp_sums = reinterpret_cast<int*>(s.prev + (warm ? 5 * (size_t)ccap : 0));
  return s;
}

__global__ void __launch_bounds__(kThreads, 1)
hull_emit_kernel(const float* __restrict__ geom, const int* __restrict__ lanes, const float* __restrict__ em_f,
                 const int* __restrict__ em_i, const int* __restrict__ dropped2, const float* __restrict__ gv,
                 const float* __restrict__ vbias, const float* __restrict__ pcols, float* __restrict__ table,
                 float* __restrict__ meta, float* __restrict__ warm, Dims d) {
  extern __shared__ __align__(16) char smem_raw[];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int start = (d.bucket0 + b) * kBlock;
  const int n_pair_e = d.kk * d.sat_cap;
  const int n_gnd = d.kg * kBlock;
  const int e_tot = n_pair_e + n_gnd;
  const bool has_warm = pcols != nullptr;
  const size_t cp = (size_t)d.nb * d.ccap;
  const size_t n_em = (size_t)d.nb * n_pair_e;
  const size_t em0 = (size_t)b * n_pair_e;
  Smem s = carve(smem_raw, e_tot, n_gnd, d.ccap, has_warm);
  const int vs = (d.vcap + 7) / 8 * 8;

  // ---- ground: the kg lowest vertices of each rank below the plane ----
  for (int r = tid; r < kBlock; r += blockDim.x) {
    const Hull gl = load_hull(geom, d.npad, start + r);
    const bool tok = (gl.typ > 0.5f) && (gl.typ < (float)d.h + 0.5f);
    int tq = (int)rintf(gl.typ) - 1;
    tq = tq < 0 ? 0 : (tq > d.h - 1 ? d.h - 1 : tq);
    const float* vrow = gv + (size_t)tq * vs * 3;
    const float* vb = vbias + (size_t)tq * vs;
    const bool mv = gl.movable > 0.f;
    uint32_t taken[4] = {0u, 0u, 0u, 0u};
    for (int pick = 0; pick < d.kg; ++pick) {
      float best = 0.f;
      int vidx = 0;
      for (int v = 0; v < d.vcap; ++v) {
        float g = -kBig;
        if (!((taken[v >> 5] >> (v & 31)) & 1u)) {
          const float lx = tok ? __ldg(vrow + 3 * v) : 0.f;
          const float ly = tok ? __ldg(vrow + 3 * v + 1) : 0.f;
          const float lz = tok ? __ldg(vrow + 3 * v + 2) : 0.f;
          const float vbl = tok ? __ldg(vb + v) : 0.f;
          float wy = lx * gl.r[3] + ly * gl.r[4] + lz * gl.r[5];
          wy = wy + gl.p.y;
          const float depth = d.gh - wy;
          g = (mv && (depth > 0.f)) ? depth + vbl : -kBig;
        }
        if (v == 0 || g > best) {
          best = g;
          vidx = v;
        }
      }
      taken[vidx >> 5] |= 1u << (vidx & 31);
      const bool act = best > 0.f;
      const float lx = tok ? __ldg(vrow + 3 * vidx) : 0.f;
      const float ly = tok ? __ldg(vrow + 3 * vidx + 1) : 0.f;
      const float lz = tok ? __ldg(vrow + 3 * vidx + 2) : 0.f;
      const int ge = pick * kBlock + r;
      float* gr = s.gnd + (size_t)8 * ge;
      gr[0] = gl.p.x + gl.r[0] * lx + gl.r[1] * ly + gl.r[2] * lz;
      gr[1] = gl.p.y + gl.r[3] * lx + gl.r[4] * ly + gl.r[5] * lz;
      gr[2] = gl.p.z + gl.r[6] * lx + gl.r[7] * ly + gl.r[8] * lz;
      gr[3] = lx;
      gr[4] = ly;
      gr[5] = lz;
      gr[6] = act ? best : 0.f;
      gr[7] = (float)vidx;
      s.slot[n_pair_e + ge] = act ? 1 : 0;
    }
  }
  __syncthreads();

  // ---- stable compaction of the emissions into ccap slots ----
  int n_act = 0;
  for (int e0 = 0; e0 < e_tot; e0 += blockDim.x) {
    const int e = e0 + tid;
    int flag = 0;
    if (e < n_pair_e) flag = em_i[em0 + e];
    else if (e < e_tot) flag = s.slot[e];
    int total;
    const int pos = n_act + block_exclusive_scan(flag, s.warp_sums, total);
    if (e < e_tot) s.slot[e] = flag ? pos : -1;
    n_act += total;
  }
  __syncthreads();
  const int kept = n_act < d.ccap ? n_act : d.ccap;

  float* out = table + (size_t)b * d.ccap;
  for (int e = tid; e < e_tot; e += blockDim.x) {
    const int sl = s.slot[e];
    if (sl < 0 || sl >= d.ccap) continue;
    float v[32];
    V3 pt, a_loc, b_loc, n_loc;
    v[9] = 1.f;
    if (e < n_pair_e) {
      const size_t k = em0 + e;
      pt = mk(em_f[k], em_f[n_em + k], em_f[2 * n_em + k]);
      const V3 n = mk(em_f[3 * n_em + k], em_f[4 * n_em + k], em_f[5 * n_em + k]);
      const int lane = e % d.sat_cap;
      const int la = lanes[(size_t)b * d.sat_cap + lane];
      const int lb = lanes[((size_t)d.nb + b) * d.sat_cap + lane];
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
      const int ge = e - n_pair_e;
      const int r = ge % kBlock;
      const Hull gl = load_hull(geom, d.npad, start + r);
      const float* gr = s.gnd + (size_t)8 * ge;
      pt = mk(gr[0], gr[1], gr[2]);
      v[3] = 0.f;
      v[4] = 1.f;
      v[5] = 0.f;
      v[6] = gr[6];
      v[7] = gl.fric;
      v[8] = gl.rest;
      v[10] = gl.id;
      v[11] = 0.f;
      v[12] = 1.f;
      v[13] = (float)(start + r);
      v[14] = 0.f;
      v[15] = gr[7];
      a_loc = mk(gr[3], gr[4], gr[5]);
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
    for (int k = 0; k < d.rows; ++k) out[(size_t)k * cp + sl] = v[k];
    s.ck[sl] = v[10] + 65536.0f * (2.0f * v[15] + v[12]) + 2.0f * (v[9] - 1.0f);
    s.ch[sl] = v[11];
  }
  for (int j = kept + tid; j < d.ccap; j += blockDim.x)
    for (int k = 0; k < d.rows; ++k) out[(size_t)k * cp + j] = 0.f;

  // ---- meta: dropped, active, prefilter drops ----
  for (int i = tid; i < 8 * kBlock; i += blockDim.x) {
    const int r = i / kBlock, c = i % kBlock;
    float val = 0.f;
    if (r == 0 && c == 0) val = (float)(n_act > d.ccap ? n_act - d.ccap : 0);
    if (r == 0 && c == 1) val = (float)n_act;
    if (r == 0 && c == 2) val = (float)dropped2[b];
    meta[(size_t)r * d.nb * kBlock + (size_t)b * kBlock + c] = val;
  }
  if (!has_warm) return;

  // ---- warm start by key match within the bucket ----
  for (int i = tid; i < d.ccap; i += blockDim.x) {
    const float* pc = pcols + ((size_t)b * d.ccap + i) * 8;
    s.prev[i] = pc[0];
    s.prev[d.ccap + i] = pc[1];
    s.prev[2 * d.ccap + i] = pc[4];
    s.prev[3 * d.ccap + i] = pc[5];
    s.prev[4 * d.ccap + i] = pc[6];
  }
  __syncthreads();
  float* wout = warm + (size_t)b * d.ccap;
  for (int j = tid; j < d.ccap; j += blockDim.x) {
    float l0 = 0.f, l1 = 0.f, l2 = 0.f;
    // an empty slot keys to (−2, 0), which matches no previous key
    if (j < kept) {
      const float ck = s.ck[j], ch = s.ch[j];
      for (int i = 0; i < d.ccap; ++i) {
        if (fabsf(s.prev[i] - ck) < 0.5f && fabsf(s.prev[d.ccap + i] - ch) < 0.5f) {
          l0 = s.prev[2 * d.ccap + i];
          l1 = s.prev[3 * d.ccap + i];
          l2 = s.prev[4 * d.ccap + i];
          break;
        }
      }
    }
    wout[j] = l0;
    wout[cp + j] = l1;
    wout[2 * cp + j] = l2;
#pragma unroll
    for (int k = 3; k < 8; ++k) wout[(size_t)k * cp + j] = 0.f;
  }
}

}  // namespace

extern "C" int ht_bucket_hull_contact_table(const float* geom, const int* la, const int* lb, const float* pcols,
                                            const float* c16, const float* c32, const float* c88,
                                            const float* c80, const float* cb, const int* eidx, const float* gv,
                                            const float* vbias, float* table, float* meta, float* warm,
                                            int* lanes, int* dropped2, float* em_f, int* em_i, int nb,
                                            int bucket0, int cap, int cap2, int ccap, int kk, int kg, int npad, int rows, int h, int fp,
                                            int vcap, int d2, int d2p, int e2p, int r16, int r32, int rcb,
                                            float gh, void* stream) {
  if (kk > kNs || kg > 8 || kg > vcap || vcap > 128 || rows > 32 || (cap2 && cap2 > cap) || h < 1 ||
      ((uintptr_t)c16 & 15) || bucket0 < 0 || (size_t)(bucket0 + nb + 2) * kBlock > (size_t)npad)
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
  d.d2 = d2;
  d.d2p = d2p;
  d.e2p = e2p;
  d.r16 = r16;
  d.r32 = r32;
  d.rcb = rcb;
  d.gh = gh;
  cudaStream_t st = (cudaStream_t)stream;
  hull_prefilter_kernel<<<nb, kThreads, 0, st>>>(geom, la, lb, lanes, dropped2, d);
  const dim3 sat_grid((d.sat_cap + kSatThreads - 1) / kSatThreads, nb);
  hull_sat_kernel<<<sat_grid, kSatThreads, 0, st>>>(geom, lanes, c16, c32, c88, c80, cb, eidx, em_f, em_i, d);
  const int e_tot = kk * d.sat_cap + kg * kBlock;
  const size_t smem = emit_smem_bytes(e_tot, kg * kBlock, ccap, pcols != nullptr);
  cudaError_t err = cudaFuncSetAttribute(hull_emit_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  hull_emit_kernel<<<nb, kThreads, smem, st>>>(geom, lanes, em_f, em_i, dropped2, gv, vbias, pcols, table, meta,
                                                warm, d);
  return (int)cudaGetLastError();
}
