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
