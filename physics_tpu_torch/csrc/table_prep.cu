// The contact table's operands, built before it in one launch: the CUDA
// version of physics_tpu_torch/ops/contact_table.py table_prep (plain
// versions: contact_table.py prev_key_cols, and solver/contacts.py
// refresh_gate and fired_ref). Not a TPU kernel: the JAX package leaves this
// bookkeeping to XLA's glue (physics_tpu/ops/contact_table.py prev_key_cols,
// physics_tpu/solver/contacts.py refresh_gate and the gated refresh's tail).
// Built from PyTorch operations it took ~38 launches a gated refresh step,
// each ~1.4 µs on the card whatever N, and a strided torch.stack of the
// [C, 8] columns.
//
// Column blocks: one thread a slot s of the previous step's keys [2, C]
// (int32) and λ [3, C] (rows may be strided: the sharded table's bucket
// range), writing prev_key_cols' row s as two 16-byte stores: ck, KH, 0,
// activity, λn, λt1, λt2, 0, with ck = KH = −1 on an inactive slot (key 0).
//
// Gate blocks (the displacement-gated refresh; before the column blocks):
// block b takes ranks [128·b, 128·b + 256), the buckets b and b + 1, and
// each rank r < n its body (order[r], or r without an order) and its
// displacement since contact_ref, disp = max|Δpos| + (2·sqrt(dq2))·|h|
// (dq2 the smaller of |q − q_ref|² and |q + q_ref|², h the half extents);
// ranks ≥ n read 0, as refresh_gate pads. gate[b] = max over the 256 > thr
// (the bucket's max folded with the next one's), as int32. Then each rank of
// bucket b writes its body's row of ref_out [n, 7]: its pose (pos, quat)
// where gate[b], else its contact_ref row. With a sort order each body is
// one rank, so every row is written once.
//
// Bound: bytes. Columns: 20 read and 32 written a slot (6.3 MB written at
// the packed envs' 196,608 slots); the gate: 4·(3 + 4 + 7 + 3) read a body
// twice (by its bucket's block and the one before) and 28 written (0.9 MB at
// 32,768 bodies). ≈ 11 MB on the packed envs, 3.4 µs at 3.35 TB/s.
//
// Bit for bit with the plain versions: the int → f32 conversions are exact
// (keys < 2²⁴) and round to nearest as PyTorch's do, and λ is copied. The
// gate rounds as refresh_gate on the card: built with -fmad=false, and each
// torch.sum in the order PyTorch's reduction over the last (contiguous)
// dimension takes on the card, which deals the terms out to two threads in
// turn and adds their two partial sums: 4 terms as (t0 + t2) + (t1 + t3),
// 3 as (t0 + t2) + t1 (measured on an H100 against every order; no term is
// −0: squares). A max is exact in any order;
// every max and min here carries a NaN through, as torch.amax and
// torch.maximum do (a NaN displacement never fires its buckets).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kBucket = 128;  // ranks per bucket (contact_table.BLOCK)

struct Args {
  const int* pkey;     // [2, *] int32, row stride key_stride
  const float* plam;   // [3, *], row stride lam_stride
  float* cols;         // [C, 8] out
  int key_stride, lam_stride, c;
  // the gate (all NULL without one)
  const float* pos;     // [N, 3]
  const float* quat;    // [N, 4]
  const float* ref;     // [N, 7] contact_ref
  const float* params;  // [N, 3] half extents
  const int* order;     // [N] rank → body, or NULL (the identity)
  int* gate;            // [NB] out
  float* ref_out;       // [N, 7] out
  int n, nb;
  float thr;
};

__device__ __forceinline__ float max_nan(float a, float b) { return (a > b || a != a) ? a : b; }

__device__ __forceinline__ float min_nan(float a, float b) { return (a < b || a != a) ? a : b; }

// refresh_gate's displacement of body i
__device__ __forceinline__ float displacement(const Args& p, int i) {
  const float* x = p.pos + 3 * (size_t)i;
  const float* q = p.quat + 4 * (size_t)i;
  const float* r = p.ref + 7 * (size_t)i;
  const float* h = p.params + 3 * (size_t)i;
  const float dp = max_nan(max_nan(fabsf(x[0] - r[0]), fabsf(x[1] - r[1])), fabsf(x[2] - r[2]));
  float dm[4], ds[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float d = q[c] - r[3 + c];
    const float s = q[c] + r[3 + c];
    dm[c] = d * d;
    ds[c] = s * s;
  }
  const float dq2 = min_nan((dm[0] + dm[2]) + (dm[1] + dm[3]), (ds[0] + ds[2]) + (ds[1] + ds[3]));
  const float r_body = sqrtf((h[0] * h[0] + h[2] * h[2]) + h[1] * h[1]);
  return dp + (2.0f * sqrtf(dq2)) * r_body;
}

__device__ void gate_block(const Args& p, int b) {
  __shared__ float warp_max[kThreads / 32];
  __shared__ int fired;
  const int tid = threadIdx.x;
  const int rank = b * kBucket + tid;
  int body = -1;
  float d = 0.0f;
  if (rank < p.n) {
    body = p.order != nullptr ? p.order[rank] : rank;
    d = displacement(p, body);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) d = max_nan(d, __shfl_xor_sync(0xffffffffu, d, off));
  if ((tid & 31) == 0) warp_max[tid >> 5] = d;
  __syncthreads();
  if (tid == 0) {
    float m = warp_max[0];
#pragma unroll
    for (int w = 1; w < kThreads / 32; ++w) m = max_nan(m, warp_max[w]);
    fired = m > p.thr;
    p.gate[b] = fired;
  }
  __syncthreads();
  if (tid < kBucket && body >= 0) {
    const float* src = fired ? nullptr : p.ref + 7 * (size_t)body;
    float* dst = p.ref_out + 7 * (size_t)body;
#pragma unroll
    for (int c = 0; c < 7; ++c)
      dst[c] = src != nullptr ? src[c] : (c < 3 ? p.pos[3 * (size_t)body + c] : p.quat[4 * (size_t)body + c - 3]);
  }
}

__device__ __forceinline__ void column(const Args& p, int s) {
  const int k0 = p.pkey[s];
  const int k1 = p.pkey[(size_t)p.key_stride + s];
  const bool act = k0 != 0;
  const float4 keys = make_float4(act ? (float)k0 : -1.0f, act ? (float)(int)((unsigned)k1 - 1u) : -1.0f, 0.0f,
                                  act ? 1.0f : 0.0f);
  const float4 lam = make_float4(p.plam[s], p.plam[(size_t)p.lam_stride + s], p.plam[2 * (size_t)p.lam_stride + s],
                                 0.0f);
  float4* out = reinterpret_cast<float4*>(p.cols) + 2 * (size_t)s;
  out[0] = keys;
  out[1] = lam;
}

__global__ void __launch_bounds__(kThreads) table_prep_kernel(Args p) {
  int blk = blockIdx.x;
  if (p.gate != nullptr) {
    if (blk < p.nb) {
      gate_block(p, blk);
      return;
    }
    blk -= p.nb;
  }
  const int s = blk * kThreads + threadIdx.x;
  if (s < p.c) column(p, s);
}

}  // namespace

// keys [2, C] int32 and λ [3, C] f32 with row strides key_stride and
// lam_stride (elements), cols [C, 8] out (16-byte aligned). With a gate
// (gate != NULL): pos, quat, ref, params, order (or NULL) of n bodies, gate
// [nb] int32 and ref_out [n, 7] out, nb = ⌈n / 128⌉, thr the f32 threshold.
extern "C" int tp_table_prep(const int* pkey, int key_stride, const float* plam, int lam_stride, float* cols, int c,
                             const float* pos, const float* quat, const float* ref, const float* params,
                             const int* order, int* gate, float* ref_out, int n, int nb, float thr, void* stream) {
  const bool gated = gate != nullptr;
  if (c < 0 || (c > 0 && (pkey == nullptr || plam == nullptr || cols == nullptr)) || key_stride < c ||
      lam_stride < c || ((uintptr_t)cols & 15) ||
      (gated && (pos == nullptr || quat == nullptr || ref == nullptr || params == nullptr || ref_out == nullptr ||
                 n < 1 || nb != (n + kBucket - 1) / kBucket)))
    return (int)cudaErrorInvalidValue;
  const long long blocks = (gated ? nb : 0) + ((long long)c + kThreads - 1) / kThreads;
  if (blocks == 0) return (int)cudaSuccess;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  Args p = {pkey, plam, cols, key_stride, lam_stride, c, pos, quat, ref, params, order, gate, ref_out, n, nb, thr};
  table_prep_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
