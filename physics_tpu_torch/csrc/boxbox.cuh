// Box-box SAT manifold of one candidate lane, shared by the box contact table
// (contact_table.cu, kernel 2.2) and the banded pair-manifold kernel
// (narrowphase_banded.cu, kernel 2.8).
//
// box_box_manifold follows ops/boxbox_batched.box_box_manifold_batched
// operation by operation; with -fmad=false both kernels give the bits of the
// plain version.
#pragma once

#include "common.cuh"

constexpr int kCap = 8;          // manifold slots
constexpr float kBigNeg = -1e30f;

// One row of a narrow-phase body table: pos | world R row-major | half
// extents | friction | restitution | movable | body id (rows 0:19 of the
// block, ops/contact_table.unified_geom rows 24:43).
struct Box {
  V3 p;
  float r[9];  // world rotation, row-major
  V3 h;
  float fric, rest, movable, id;
};

// Column `col` of the narrow-phase block whose row 0 starts at `g`.
__device__ __forceinline__ Box load_box(const float* g0, int npad, int col) {
  const float* g = g0 + col;
  Box b;
  b.p = mk(g[0], g[(size_t)npad], g[2 * (size_t)npad]);
#pragma unroll
  for (int k = 0; k < 9; ++k) b.r[k] = g[(size_t)(3 + k) * npad];
  b.h = mk(g[12 * (size_t)npad], g[13 * (size_t)npad], g[14 * (size_t)npad]);
  b.fric = g[15 * (size_t)npad];
  b.rest = g[16 * (size_t)npad];
  b.movable = g[17 * (size_t)npad];
  b.id = g[18 * (size_t)npad];
  return b;
}

__device__ __forceinline__ Box zero_box() {
  Box b;
  b.p = mk(0.f, 0.f, 0.f);
#pragma unroll
  for (int k = 0; k < 9; ++k) b.r[k] = 0.f;
  b.h = b.p;
  b.fric = b.rest = b.movable = b.id = 0.f;
  return b;
}

// torch.sign(x + 1e-30)
__device__ __forceinline__ float sgn(float x) {
  const float y = x + 1e-30f;
  return y > 0.f ? 1.f : (y < 0.f ? -1.f : 0.f);
}

// boxbox_batched.box_box_manifold_batched for one pair. Normal B → A.
static __device__ void box_box_manifold(const Box& A, const Box& B, V3 (&points)[kCap],
                                        float (&depth)[kCap], bool (&valid)[kCap], V3& normal) {
  const V3 t_w = sub(B.p, A.p);
  V3 u[3], w[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    u[k] = mk(A.r[k], A.r[3 + k], A.r[6 + k]);
    w[k] = mk(B.r[k], B.r[3 + k], B.r[6 + k]);
  }
  const float ha[3] = {A.h.x, A.h.y, A.h.z};
  const float hb[3] = {B.h.x, B.h.y, B.h.z};

  V3 axes[15];
  bool ok[9];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    axes[k] = u[k];
    axes[3 + k] = w[k];
  }
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const V3 cx = cross(u[i], w[j]);
      const float nn = sqrtf(fmaxf(dot(cx, cx), 0.f));
      ok[3 * i + j] = nn > 1e-6f;
      const float inv = 1.0f / fmaxf(nn, 1e-6f);
      axes[6 + 3 * i + j] = scale(cx, inv);
    }

  float dist[15], sep[15];
#pragma unroll
  for (int k = 0; k < 15; ++k) {
    const V3 ax = axes[k];
    dist[k] = dot(ax, t_w);
    const float pa = ha[0] * fabsf(dot(ax, u[0])) + ha[1] * fabsf(dot(ax, u[1])) + ha[2] * fabsf(dot(ax, u[2]));
    const float pb = hb[0] * fabsf(dot(ax, w[0])) + hb[1] * fabsf(dot(ax, w[1])) + hb[2] * fabsf(dot(ax, w[2]));
    float s = fabsf(dist[k]) - (pa + pb);
    if (k >= 6 && !ok[k - 6]) s = -CUDART_INF_F;
    sep[k] = s;
  }
  float all_best;
  int all_idx;
  argmax(sep, all_best, all_idx);
  const bool separated = all_best > 0.f;

  float face_sep[6], edge_sep[9], face_dist[6], edge_dist[9];
  V3 face_ax[6], edge_ax[9];
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    face_sep[k] = sep[k];
    face_dist[k] = dist[k];
    face_ax[k] = axes[k];
  }
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    edge_sep[k] = sep[6 + k];
    edge_dist[k] = dist[6 + k];
    edge_ax[k] = axes[6 + k];
  }
  float best_face_sep, best_edge_sep;
  int best_face, best_edge;
  argmax(face_sep, best_face_sep, best_face);
  argmax(edge_sep, best_edge_sep, best_edge);
  bool any_edge = false;
#pragma unroll
  for (int k = 0; k < 9; ++k) any_edge = any_edge || ok[k];
  if (!any_edge) best_edge_sep = -CUDART_INF_F;
  const bool use_edge = best_edge_sep * 1.05f > best_face_sep;

  const V3 n_face = scale(select(best_face, face_ax), sgn(select(best_face, face_dist)));
  const V3 n_edge = scale(select(best_edge, edge_ax), sgn(select(best_edge, edge_dist)));

  // ---- face-contact manifold ----
  const bool ref_is_a = best_face < 3;
  const int ref_axis = ref_is_a ? best_face : best_face - 3;
  V3 ref_cols[3], inc_cols[3];
  float ref_half[3], inc_half[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    ref_cols[k] = vsel(ref_is_a, u[k], w[k]);
    inc_cols[k] = vsel(ref_is_a, w[k], u[k]);
    ref_half[k] = ref_is_a ? ha[k] : hb[k];
    inc_half[k] = ref_is_a ? hb[k] : ha[k];
  }
  const V3 ref_pos = vsel(ref_is_a, A.p, B.p);
  const V3 inc_pos = vsel(ref_is_a, B.p, A.p);
  const V3 ref_n = vsel(ref_is_a, n_face, neg(n_face));

  const int p_idx = ref_axis == 0 ? 1 : 0;
  const int q_idx = ref_axis == 2 ? 1 : 2;
  const V3 u_p = select(p_idx, ref_cols);
  const V3 u_q = select(q_idx, ref_cols);
  const float h_p = select(p_idx, ref_half);
  const float h_q = select(q_idx, ref_half);
  const float h_axis = select(ref_axis, ref_half);
  const V3 c_ref = add(ref_pos, scale(ref_n, h_axis));

  float align[3], aabs[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    align[k] = dot(inc_cols[k], ref_n);
    aabs[k] = fabsf(align[k]);
  }
  float unused;
  int inc_axis;
  argmax(aabs, unused, inc_axis);
  const float inc_sign = -sgn(select(inc_axis, align));
  const V3 inc_n_axis = select(inc_axis, inc_cols);
  const float inc_h = select(inc_axis, inc_half);
  const V3 c_inc = add(inc_pos, scale(inc_n_axis, inc_sign * inc_h));
  const int ip_idx = inc_axis == 0 ? 1 : 0;
  const int iq_idx = inc_axis == 2 ? 1 : 2;
  const V3 w_p = scale(select(ip_idx, inc_cols), select(ip_idx, inc_half));
  const V3 w_q = scale(select(iq_idx, inc_cols), select(iq_idx, inc_half));

  const float sps[4] = {1.f, 1.f, -1.f, -1.f};
  const float sqs[4] = {1.f, -1.f, -1.f, 1.f};
  float pu[kCap], pv[kCap], ps[kCap];
#pragma unroll
  for (int k = 0; k < kCap; ++k) pu[k] = pv[k] = ps[k] = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const V3 corner = add(c_inc, add(scale(w_p, sps[k]), scale(w_q, sqs[k])));
    const V3 rel = sub(corner, c_ref);
    pu[k] = dot(rel, u_p);
    pv[k] = dot(rel, u_q);
    ps[k] = dot(rel, ref_n);
  }
  int m = 4;
  clip(pu, pv, ps, m, 1.f, 0.f, h_p);
  clip(pu, pv, ps, m, -1.f, 0.f, h_p);
  clip(pu, pv, ps, m, 0.f, 1.f, h_q);
  clip(pu, pv, ps, m, 0.f, -1.f, h_q);

  // ---- edge-contact point ----
  const int ei = best_edge / 3;
  const int ej = best_edge % 3;
  const V3 ua = select(ei, u);
  const V3 vb = select(ej, w);
  V3 p_a = A.p, p_b = B.p;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float sa = sgn(dot(u[k], n_edge)) * (float)(ei != k) * ha[k];
    p_a = add(p_a, scale(u[k], sa));
    const float sb = sgn(-dot(w[k], n_edge)) * (float)(ej != k) * hb[k];
    p_b = add(p_b, scale(w[k], sb));
  }
  const V3 d_ab = sub(p_b, p_a);
  const float c_uv = dot(ua, vb);
  const float denom = 1.0f - c_uv * c_uv;
  const float s_par = fabsf(denom) > 1e-9f ? (dot(d_ab, ua) - c_uv * dot(d_ab, vb)) / denom : 0.f;
  const float r_par = s_par * c_uv - dot(d_ab, vb);
  const V3 q_a = add(p_a, scale(ua, s_par));
  const V3 q_b = add(p_b, scale(vb, r_par));
  const V3 edge_point = scale(add(q_a, q_b), 0.5f);
  const float edge_depth = -select(best_edge, edge_sep);

  // ---- combine ----
#pragma unroll
  for (int k = 0; k < kCap; ++k) {
    const V3 fp = add(c_ref, add(add(scale(u_p, pu[k]), scale(u_q, pv[k])), scale(ref_n, ps[k])));
    const float fd = -ps[k];
    const bool fv = (k < m) && (fd > 0.f);
    if (k == 0) {
      points[k] = vsel(use_edge, edge_point, fp);
      depth[k] = use_edge ? edge_depth : fd;
      valid[k] = ((use_edge && (edge_depth > 0.f)) || (!use_edge && fv)) && !separated;
    } else {
      points[k] = fp;
      depth[k] = use_edge ? 0.f : fd;
      valid[k] = !use_edge && fv && !separated;
    }
  }
  normal = neg(vsel(use_edge, n_edge, n_face));
}
