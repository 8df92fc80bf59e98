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

// ---------------------------------------------------------------------------
// The warm match of both contact tables (contact_table.cu, hull_table.cu)
// ---------------------------------------------------------------------------

constexpr int kWarmThreads = 256;
constexpr int kWarmSlots = 64;  // slots a block (8 a warp)

// Called by every thread of a block: one bucket's previous keys, pc = its
// prev_key_cols rows ([ccap, 8]: ck, KH, 0, activity, λ xyz, 0), as (ck, KH)
// pairs in prev [ccap], and in *n_prev 1 + the last one keyed >= 0 (an
// inactive previous slot is −1, which no key matches): the warm match reads
// only those.
__device__ __forceinline__ void compact_prev_keys(const float* __restrict__ pc, float2* __restrict__ prev,
                                                  int* __restrict__ n_prev, int ccap) {
  __shared__ int limit;
  if (threadIdx.x == 0) limit = 0;
  __syncthreads();
  int last = 0;
  for (int i = threadIdx.x; i < ccap; i += blockDim.x) {
    const float2 k = *reinterpret_cast<const float2*>(pc + (size_t)i * 8);
    prev[i] = k;
    if (k.x > -0.5f) last = i + 1;
  }
  atomicMax(&limit, last);
  __syncthreads();
  if (threadIdx.x == 0) *n_prev = limit;
}

// Each slot's warm-start impulse: the λ of the first previous slot of its
// bucket within 0.5 on both keys, rows 0:3 of warm [8, NB·ccap], rows 3:8
// zero. prev / n_prev are compact_prev_keys' (bucket b's at b·ccap / b),
// keys [2, NB·ccap] the slots' (ck, KH); the first min(nact[b], ccap) slots
// of bucket b are live. A live slot's key is >= 0 and an empty one's −2, so
// an empty slot matches nothing: a warp takes its 8 slots in turn, each
// scanning the n_prev previous slots by ballots over 4 × 32 at a time (no
// branch a comparison); the lowest set bit is the serial scan's first
// match. `Table` names each table's instance.
template <class Table>
__global__ void __launch_bounds__(kWarmThreads)
warm_match_kernel(const float* __restrict__ pcols, const float2* __restrict__ prev, const int* __restrict__ n_prevs,
                  const float* __restrict__ keys, const int* __restrict__ nact, float* __restrict__ warm, int nb,
                  int ccap) {
  extern __shared__ __align__(16) char smem_raw[];
  float* prev_ck = reinterpret_cast<float*>(smem_raw);  // [ccap]
  float* prev_kh = prev_ck + ccap;                       // [ccap]
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31, wid = tid >> 5;
  const size_t cp = (size_t)nb * ccap;
  const float* pc = pcols + (size_t)b * ccap * 8;
  const int n_prev = n_prevs[b];
  // up to a multiple of 128 (at most ccap): the rest keyed −1, no match
  const int n_pad = (n_prev + 127) / 128 * 128;
  for (int i = tid; i < n_pad; i += blockDim.x) {
    const float2 k = i < n_prev ? prev[(size_t)b * ccap + i] : make_float2(-1.f, -1.f);
    prev_ck[i] = k.x;
    prev_kh[i] = k.y;
  }
  __syncthreads();
  const int kept = nact[b] < ccap ? nact[b] : ccap;
  constexpr int per_warp = kWarmSlots / (kWarmThreads / 32);
  const int j0 = blockIdx.x * kWarmSlots + wid * per_warp;
  // the warp's slots' keys, one a thread, then each slot's match in turn
  float my_ck = -2.f, my_ch = 0.f;
  if (lane < per_warp && j0 + lane < kept) {
    my_ck = keys[(size_t)b * ccap + j0 + lane];
    my_ch = keys[cp + (size_t)b * ccap + j0 + lane];
  }
  int my_src = -1;  // thread s: slot j0 + s's previous slot
  for (int s = 0; s < per_warp; ++s) {
    const float ck = __shfl_sync(0xffffffffu, my_ck, s);
    const float ch = __shfl_sync(0xffffffffu, my_ch, s);
    int src = -1;
    for (int i0 = 0; ck >= 0.f && i0 < n_prev && src < 0; i0 += 128) {
      unsigned ballot[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + 32 * u + lane;
        const bool hit = (fabsf(prev_ck[i] - ck) < 0.5f) & (fabsf(prev_kh[i] - ch) < 0.5f);
        ballot[u] = __ballot_sync(0xffffffffu, hit);
      }
#pragma unroll
      for (int u = 3; u >= 0; --u)
        if (ballot[u]) src = i0 + 32 * u + __ffs(ballot[u]) - 1;
    }
    if (lane == s) my_src = src;
  }
  // thread l writes row l % 8 of slot j0 + l / 8 (and of the slot 4 further on)
  for (int k = lane; k < 8 * per_warp; k += 32) {
    const int s = k >> 3, row = k & 7;
    const int src = __shfl_sync(0xffffffffu, my_src, s);
    const int j = j0 + s;
    if (j < ccap) warm[(size_t)row * cp + (size_t)b * ccap + j] = (row < 3 && src >= 0) ? pc[(size_t)src * 8 + 4 + row] : 0.f;
  }
}

// Launches warm_match_kernel<Table> over the NB buckets' slots (ccap a
// multiple of 128).
template <class Table>
inline cudaError_t launch_warm_match(const float* pcols, const float2* prev, const int* n_prev, const float* keys,
                                     const int* nact, float* warm, int nb, int ccap, cudaStream_t st) {
  const size_t smem = (size_t)2 * ccap * 4;
  const cudaError_t err =
      cudaFuncSetAttribute(warm_match_kernel<Table>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  warm_match_kernel<Table><<<dim3(ccap / kWarmSlots, nb), kWarmThreads, smem, st>>>(pcols, prev, n_prev, keys, nact,
                                                                                    warm, nb, ccap);
  return cudaSuccess;
}
