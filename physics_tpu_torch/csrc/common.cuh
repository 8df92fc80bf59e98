// Shared device helpers for the physics_tpu_torch kernels.
//
// Every helper spells out its operations in the order of the PyTorch plain
// versions (maths/vec3c.py), and the library is built with -fmad=false, so
// each multiply and add is rounded as PyTorch rounds it.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 mk(float x, float y, float z) {
  V3 r;
  r.x = x;
  r.y = y;
  r.z = z;
  return r;
}
__device__ __forceinline__ V3 add(V3 a, V3 b) { return mk(a.x + b.x, a.y + b.y, a.z + b.z); }
__device__ __forceinline__ V3 sub(V3 a, V3 b) { return mk(a.x - b.x, a.y - b.y, a.z - b.z); }
__device__ __forceinline__ V3 scale(V3 a, float s) { return mk(a.x * s, a.y * s, a.z * s); }
__device__ __forceinline__ V3 neg(V3 a) { return mk(-a.x, -a.y, -a.z); }
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return mk(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x);
}
__device__ __forceinline__ V3 vsel(bool m, V3 a, V3 b) { return m ? a : b; }

// Row-major 3x3 times vector (vec3c.mat_vec).
__device__ __forceinline__ V3 mat_vec(const float* m, V3 v) {
  return mk(m[0] * v.x + m[1] * v.y + m[2] * v.z,
            m[3] * v.x + m[4] * v.y + m[5] * v.z,
            m[6] * v.x + m[7] * v.y + m[8] * v.z);
}

// Rᵀ·w for a row-major rotation (contact_table._t_apply).
__device__ __forceinline__ V3 t_apply(const float* r, V3 w) {
  return mk(r[0] * w.x + r[3] * w.y + r[6] * w.z,
            r[1] * w.x + r[4] * w.y + r[7] * w.z,
            r[2] * w.x + r[5] * w.y + r[8] * w.z);
}

// Best separation over the 6 face axes of two oriented boxes with centre
// offset t, rotations ra/rb and half extents ha/hb; > 0 ⇒ no contact
// (contact_table._face_sat_sep).
__device__ __forceinline__ float face_sat_sep(V3 t, const float* ra, const float* rb, V3 ha, V3 hb) {
  const float hav[3] = {ha.x, ha.y, ha.z};
  const float hbv[3] = {hb.x, hb.y, hb.z};
  float cabs[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      cabs[i][j] = fabsf(ra[i] * rb[j] + ra[3 + i] * rb[3 + j] + ra[6 + i] * rb[6 + j]);
  float best = 0.f;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float ut = ra[i] * t.x + ra[3 + i] * t.y + ra[6 + i] * t.z;
    const float rad = hav[i] + hb.x * cabs[i][0] + hb.y * cabs[i][1] + hb.z * cabs[i][2];
    const float s = fabsf(ut) - rad;
    best = i == 0 ? s : fmaxf(best, s);
  }
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float wt = rb[j] * t.x + rb[3 + j] * t.y + rb[6 + j] * t.z;
    const float rad = hbv[j] + ha.x * cabs[0][j] + ha.y * cabs[1][j] + ha.z * cabs[2][j];
    best = fmaxf(best, fabsf(wt) - rad);
  }
  return best;
}

// One Sutherland–Hodgman half-plane clip (boxbox_batched._clip): keep
// cu·u + cv·v <= d of the m-point polygon held in CAP slots, of which the
// first cap_rt are the polygon's (a hull library's 2E clip slots held in a
// larger compile-time capacity): the output keeps cap_rt slots, the rest
// stay 0, so the result is the cap_rt-slot clip's.
template <int CAP>
__device__ __forceinline__ void clip(float (&pu)[CAP], float (&pv)[CAP], float (&ps)[CAP], int& m, float cu,
                                     float cv, float d, int cap_rt = CAP) {
  float g[CAP], gn[CAP], un[CAP], vn[CAP], sn[CAP];
#pragma unroll
  for (int i = 0; i < CAP; ++i) g[i] = cu * pu[i] + cv * pv[i] - d;
#pragma unroll
  for (int i = 0; i < CAP; ++i) {
    const bool wrap = (i + 1) == m;
    const int j = (i + 1) % CAP;
    gn[i] = wrap ? g[0] : g[j];
    un[i] = wrap ? pu[0] : pu[j];
    vn[i] = wrap ? pv[0] : pv[j];
    sn[i] = wrap ? ps[0] : ps[j];
  }
  int pos_cur[CAP], pos_int[CAP];
  float iu[CAP], iv[CAP], is[CAP];
  int start = 0, total = 0;
#pragma unroll
  for (int i = 0; i < CAP; ++i) {
    const bool live = i < m;
    const bool inside = (g[i] <= 0.f) && live;
    const bool crossing = ((g[i] <= 0.f) != (gn[i] <= 0.f)) && live;
    const float denom = g[i] - gn[i];
    const float t = fabsf(denom) > 1e-12f ? g[i] / denom : 0.f;
    iu[i] = pu[i] + t * (un[i] - pu[i]);
    iv[i] = pv[i] + t * (vn[i] - pv[i]);
    is[i] = ps[i] + t * (sn[i] - ps[i]);
    const int emit = (int)inside + (int)crossing;
    pos_cur[i] = inside ? start : CAP;
    pos_int[i] = crossing ? start + (int)inside : CAP;
    start += emit;
    total += emit;
  }
  float ou[CAP], ov[CAP], os[CAP];
#pragma unroll
  for (int j = 0; j < CAP; ++j) {
    float au = 0.f, av = 0.f, as = 0.f;
#pragma unroll
    for (int i = 0; i < CAP; ++i) {
      const bool mc = pos_cur[i] == j && j < cap_rt;
      const bool mi = pos_int[i] == j && j < cap_rt;
      au = au + (mc ? pu[i] : 0.f) + (mi ? iu[i] : 0.f);
      av = av + (mc ? pv[i] : 0.f) + (mi ? iv[i] : 0.f);
      as = as + (mc ? ps[i] : 0.f) + (mi ? is[i] : 0.f);
    }
    ou[j] = au;
    ov[j] = av;
    os[j] = as;
  }
#pragma unroll
  for (int j = 0; j < CAP; ++j) {
    pu[j] = ou[j];
    pv[j] = ov[j];
    ps[j] = os[j];
  }
  m = total < cap_rt ? total : cap_rt;
}

// (best, idx) over N values; ties keep the lowest index.
template <int N>
__device__ __forceinline__ void argmax(const float (&v)[N], float& best, int& idx) {
  best = v[0];
  idx = 0;
#pragma unroll
  for (int k = 1; k < N; ++k) {
    if (v[k] > best) {
      best = v[k];
      idx = k;
    }
  }
}

template <typename T, int N>
__device__ __forceinline__ T select(int idx, const T (&items)[N]) {
  T out = items[0];
#pragma unroll
  for (int k = 1; k < N; ++k) out = idx == k ? items[k] : out;
  return out;
}

// Block-wide exclusive prefix sum of one int per thread (blockDim a multiple
// of 32, at most 1024). `warp_sums` is 32 ints of shared memory. Every thread
// of the block must call it; `total` receives the block's sum.
__device__ __forceinline__ int block_exclusive_scan(int v, int* warp_sums, int& total) {
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[wid] = x;
  __syncthreads();
  if (wid == 0) {
    int s = lane < nw ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      int y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    if (lane < nw) warp_sums[lane] = s;
  }
  __syncthreads();
  const int off = wid ? warp_sums[wid - 1] : 0;
  total = warp_sums[nw - 1];
  __syncthreads();
  return off + x - v;
}
