// The joint solve's conjugate gradient (Hopper, sm_90a): the whole loop of
// physics_tpu/solver/cg.py `solve` in one launch, on the matrix-free
// operator A(λ) = J·W·Jᵀλ of the joint rows (physics_tpu/engine.py
// solve_joints). The JAX package has no Pallas kernel here: the loop is an
// XLA lax.while_loop of up to cg_max_iters iterations with a device-side
// stop (cg.py:79). Plain version: physics_tpu_torch/solver/cg.py
// (solve_plain with solver/joints.py `operator`), which the device code
// below follows operation by operation.
//
// CG as the reference runs it: the warm start x0; r = rhs − A·x0, p = r;
// threshold = max(‖rhs‖∞·rel_tol, abs_tol); each iteration
// α = r·r / p·Ap (0 where p·Ap is 0), x += α·p, r −= α·Ap, converged when
// ‖r‖∞ < threshold (tested after the x update), β = r·r new / old (0 where
// old is 0), p = r + β·p; at most max_iters iterations.
//
// The operator, matrix-free from each joint slot's two 3×6 blocks (body a,
// body b; rows already masked by slot type): Jᵀλ scatters each slot's
// 6-vectors onto its bodies with atomicAdd into a body table F [N, 6]; W
// (W [N, 10]: a linear scale, then a 3×3 angular block, row-major: 1/m and
// diag(1/m) in compat, quirk Q3; else inv_mass and the world-frame inverse
// inertia) is applied to F inside the gather, y = J_a·W_a F_a + J_b·W_b F_b.
//
// The design: one cooperative persistent grid (cudaLaunchKernelEx with
// cudaLaunchAttributeCooperative, as csrc/banded_solve.cu's solve), blocks
// of 256 threads, each thread K consecutive slots (K = 1, 2, 4 or 8: the
// least that fits the grid on the card; beyond 8 a thread, some 540,000
// slots on an H100, the launch is refused), whose x, r, p and Ap it keeps in
// registers across the iterations; three grid barriers an iteration (after
// the scatter; after the partial sums of p·Ap; after those of ‖r‖∞ and
// r·r) and two alternating body tables, so each is zeroed while the other
// is in use. A reduction is one fixed tree, the same in every block and in
// the plain version: each slot's 3 rows summed (r0 + r1) + r2, then
// adjacent pairs level by level over the slot sequence padded with zeros to
// a power of two (a thread's K slots, the warp by xor shuffles, the block's
// 8 warps, then every block sums the blocks' partials itself), so every
// block computes the same scalars and takes the same branch, and α, β and
// the stop equal the plain version's. A body with at most two joint rows'
// slots gets its atomic sum in either order with the same bits (a + b =
// b + a; exact zeros are skipped); with more, the order of its atomic adds
// varies from run to run.
// What bounds it on the H100: not bytes (the rows, 2.4 MB at the 4,096
// packed pendulums, are read from L2 each iteration) nor operations
// (~250 a slot an iteration) but the chain of dependent steps: three grid
// barriers and two block-partial sums an iteration, a few µs, times the
// iterations the data needs. Nothing is read back: the result, the
// iteration count and the stop stay in device memory.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace {

namespace cgrp = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kW = 10;            // floats of a body's W block
constexpr int kMaxDevices = 64;
constexpr int kMaxGrid = 1024;

struct Params {
  const float* ja;      // [J, 3, 6] body a's rows (masked)
  const float* jb;      // [J, 3, 6] body b's rows (masked)
  const int* body_a;    // [J] (clamped to a body)
  const int* body_b;    // [J] (clamped; read only with has_b)
  const int* flags;     // [J] bit 0 live (a row), bit 1 has_b
  const float* w;       // [N, 10]
  const float* rhs;     // [3J]
  const float* x0;      // [3J] warm start
  float* x;             // [3J] out
  int* status;          // [2] out: iterations, converged
  float* f;             // [2, N, 6] scratch: the two body tables
  float* part;          // [3, grid] scratch: the blocks' partials
  int nj, nb, max_iters;
  int grid, pchunk;     // blocks; partials a lane of the grand total's warp
  float rel_tol, abs_tol;
};

// max that keeps a NaN (as torch.amax does)
__device__ __forceinline__ float nan_max(float a, float b) { return (a != a || a > b) ? a : b; }

// every lane of the warp ends with the adjacent-pair tree over its 32
// values (lane i with i ^ 1, then pairs of pairs: a + b = b + a)
__device__ __forceinline__ float warp_tree_sum(float v) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The block's partials: the tree over its threads' values (warps, then the
// 8 warp totals in warp 0), written by thread 0 to out[blockIdx.x].
__device__ void block_sum(float v, float* out, float* sh) {
  v = warp_tree_sum(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = warp_tree_sum(lane < kWarps ? sh[lane] : 0.f);
    if (lane == 0) out[blockIdx.x] = v;
  }
}

__device__ void block_max(float v, float* out, float* sh) {
  v = warp_max(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = warp_max(lane < kWarps ? sh[lane] : 0.f);
    if (lane == 0) out[blockIdx.x] = v;
  }
}

// The grand totals of the blocks' partials, computed by every block alike:
// warp 0's lane l sums partials [l·pchunk, (l + 1)·pchunk) by the
// adjacent-pair tree (zeros past the grid), then the warp tree. Returned to
// every thread of the block.
template <bool kMax>
__device__ float grid_total(const Params& p, const float* part, float* sh) {
  const int lane = threadIdx.x & 31;
  __syncthreads();
  if (threadIdx.x < 32) {
    float v[32];
    const int c = p.pchunk;
    for (int i = 0; i < c; ++i) {
      const int b = lane * c + i;
      v[i] = b < p.grid ? part[b] : 0.f;
    }
    for (int s = 1; s < c; s <<= 1)
      for (int i = 0; i < c; i += 2 * s) v[i] = kMax ? nan_max(v[i], v[i + s]) : v[i] + v[i + s];
    const float t = kMax ? warp_max(v[0]) : warp_tree_sum(v[0]);
    if (lane == 0) sh[kWarps] = t;
  }
  __syncthreads();
  return sh[kWarps];
}

// Jᵀv onto the body table: a live slot's 6-vector (j₀c·v₀ + j₁c·v₁) + j₂c·v₂
// added to its body a (and body b with has_b), skipping exact zeros.
__device__ __forceinline__ void scatter_side(const float* j, const float v[3], float* fb) {
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    const float t = (j[c] * v[0] + j[6 + c] * v[1]) + j[12 + c] * v[2];
    if (t != 0.f) atomicAdd(fb + c, t);
  }
}

// J·(W F) of one side: W applied to the body's F (linear scale; the 3×3
// angular block, (m₀·f₃ + m₁·f₄) + m₂·f₅ a row), then each row's six
// products summed left to right.
__device__ __forceinline__ void gather_side(const float* j, const float* fb, const float* wb, float y[3]) {
  float u[6];
  const float ls = wb[0];
  u[0] = fb[0] * ls;
  u[1] = fb[1] * ls;
  u[2] = fb[2] * ls;
#pragma unroll
  for (int i = 0; i < 3; ++i) u[3 + i] = (wb[1 + 3 * i] * fb[3] + wb[2 + 3 * i] * fb[4]) + wb[3 + 3 * i] * fb[5];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    float s = j[6 * r] * u[0];
#pragma unroll
    for (int c = 1; c < 6; ++c) s = s + j[6 * r + c] * u[c];
    y[r] = s;
  }
}

template <int K>
__device__ void scatter(const Params& p, int base, const float v[K][3], float* f) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int s = base + k;
    if (s >= p.nj) continue;
    const int fl = p.flags[s];
    if (!(fl & 1)) continue;
    scatter_side(p.ja + 18 * (size_t)s, v[k], f + 6 * (size_t)p.body_a[s]);
    if (fl & 2) scatter_side(p.jb + 18 * (size_t)s, v[k], f + 6 * (size_t)p.body_b[s]);
  }
}

template <int K>
__device__ void gather(const Params& p, int base, const float* f, float y[K][3]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int s = base + k;
    y[k][0] = y[k][1] = y[k][2] = 0.f;
    if (s >= p.nj) continue;
    const int fl = p.flags[s];
    if (!(fl & 1)) continue;
    const int a = p.body_a[s];
    gather_side(p.ja + 18 * (size_t)s, f + 6 * (size_t)a, p.w + kW * (size_t)a, y[k]);
    if (fl & 2) {
      const int b = p.body_b[s];
      float yb[3];
      gather_side(p.jb + 18 * (size_t)s, f + 6 * (size_t)b, p.w + kW * (size_t)b, yb);
      y[k][0] = y[k][0] + yb[0];
      y[k][1] = y[k][1] + yb[1];
      y[k][2] = y[k][2] + yb[2];
    }
  }
}

// a thread's K slots: each slot's (a₀b₀ + a₁b₁) + a₂b₂, then the
// adjacent-pair tree over the K slots
template <int K>
__device__ __forceinline__ float thread_dot(const float a[K][3], const float b[K][3]) {
  float v[K];
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = (a[k][0] * b[k][0] + a[k][1] * b[k][1]) + a[k][2] * b[k][2];
#pragma unroll
  for (int s = 1; s < K; s <<= 1)
#pragma unroll
    for (int i = 0; i < K; i += 2 * s) v[i] = v[i] + v[i + s];
  return v[0];
}

template <int K>
__device__ __forceinline__ float thread_amax(const float a[K][3]) {
  float m = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int r = 0; r < 3; ++r) m = nan_max(fabsf(a[k][r]), m);
  return m;
}

__device__ void zero_table(const Params& p, float* f) {
  const size_t n = 6 * (size_t)p.nb;
  for (size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x; i < n; i += (size_t)gridDim.x * kThreads) f[i] = 0.f;
}

// at least two blocks an SM (128 registers a thread): the grid of K = 8
// holds 8·256·2 slots an SM
template <int K>
__global__ void __launch_bounds__(kThreads, 2) cg_kernel(Params p) {
  cgrp::grid_group grid = cgrp::this_grid();
  __shared__ float sh[kWarps + 1];
  const int base = (blockIdx.x * kThreads + threadIdx.x) * K;
  const size_t tbl = 6 * (size_t)p.nb;
  float* const p_dot = p.part;               // p·Ap
  float* const p_amax = p.part + p.grid;     // ‖r‖∞ (setup: ‖rhs‖∞)
  float* const p_rr = p.part + 2 * p.grid;   // r·r

  float x[K][3], r[K][3], d[K][3], ad[K][3];  // d: the direction p
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const int s = base + k;
      x[k][c] = s < p.nj ? p.x0[3 * s + c] : 0.f;
      r[k][c] = s < p.nj ? p.rhs[3 * s + c] : 0.f;   // rhs until r0
    }
  zero_table(p, p.f);
  zero_table(p, p.f + tbl);
  grid.sync();
  // r0 = rhs − A·x0, p0 = r0
  scatter<K>(p, base, x, p.f);
  grid.sync();
  gather<K>(p, base, p.f, ad);
  block_max(thread_amax<K>(r), p_amax, sh);
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      r[k][c] = r[k][c] - ad[k][c];
      d[k][c] = r[k][c];
    }
  block_sum(thread_dot<K>(r, r), p_rr, sh);
  grid.sync();
  // max(‖rhs‖∞·rel, abs), a NaN norm kept (as the reference's maximum)
  const float scaled = grid_total<true>(p, p_amax, sh) * p.rel_tol;
  const float threshold = scaled != scaled ? scaled : fmaxf(scaled, p.abs_tol);
  float rk = grid_total<false>(p, p_rr, sh);

  int iters = 0;
  bool converged = false;
  for (int it = 0; it < p.max_iters; ++it) {
    float* cur = p.f + ((it + 1) & 1) * tbl;
    zero_table(p, p.f + (it & 1) * tbl);   // the previous iteration's table
    scatter<K>(p, base, d, cur);
    grid.sync();
    gather<K>(p, base, cur, ad);
    block_sum(thread_dot<K>(d, ad), p_dot, sh);
    grid.sync();
    const float den = grid_total<false>(p, p_dot, sh);
    const float alpha = den != 0.f ? rk / den : 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        x[k][c] = x[k][c] + alpha * d[k][c];
        r[k][c] = r[k][c] - alpha * ad[k][c];
      }
    block_max(thread_amax<K>(r), p_amax, sh);
    block_sum(thread_dot<K>(r, r), p_rr, sh);
    grid.sync();
    const float amax = grid_total<true>(p, p_amax, sh);
    const float rk_new = grid_total<false>(p, p_rr, sh);
    converged = amax < threshold;
    const float beta = rk != 0.f ? rk_new / rk : 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int c = 0; c < 3; ++c) d[k][c] = r[k][c] + beta * d[k][c];
    iters = it + 1;
    if (converged) break;
    rk = rk_new;
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int s = base + k;
    if (s < p.nj)
#pragma unroll
      for (int c = 0; c < 3; ++c) p.x[3 * s + c] = x[k][c];
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    p.status[0] = iters;
    p.status[1] = converged ? 1 : 0;
  }
}

// The launch for nj slots: the least K of 1, 2, 4, 8 whose grid
// (nj / (256·K) blocks, rounded up) the card holds resident.
struct Plan {
  int k, grid, per_sm, regs;
};

template <int K>
cudaError_t occupancy(int& per_sm, int& regs) {
  cudaFuncAttributes fa;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, cg_kernel<K>, kThreads, 0);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, cg_kernel<K>);
  regs = fa.numRegs;
  return err;
}

cudaError_t plan(int nj, Plan& pl) {
  // per device, once: not stream work, so a captured call makes none
  static int sms[kMaxDevices], occ[kMaxDevices][4], regs[kMaxDevices][4];
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (sms[dev] == 0) {
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) err = occupancy<1>(occ[dev][0], regs[dev][0]);
    if (err == cudaSuccess) err = occupancy<2>(occ[dev][1], regs[dev][1]);
    if (err == cudaSuccess) err = occupancy<4>(occ[dev][2], regs[dev][2]);
    if (err == cudaSuccess) err = occupancy<8>(occ[dev][3], regs[dev][3]);
    if (err != cudaSuccess) {
      sms[dev] = 0;
      return err;
    }
  }
  for (int i = 0; i < 4; ++i) {
    const int k = 1 << i;
    const int g = (nj + kThreads * k - 1) / (kThreads * k);
    // at most kMaxGrid blocks: the grand totals' warp sums 32 a lane
    if (g <= occ[dev][i] * sms[dev] && g <= kMaxGrid) {
      pl.k = k;
      pl.grid = g > 0 ? g : 1;
      pl.per_sm = occ[dev][i];
      pl.regs = regs[dev][i];
      return cudaSuccess;
    }
  }
  return cudaErrorCooperativeLaunchTooLarge;
}

template <int K>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, cg_kernel<K>, p);
}

}  // namespace

// The CG of the joint rows of nj slots over nb bodies (see the top of this
// file); part_len floats of partials scratch (3 a block).
extern "C" int jcg_solve(const float* ja, const float* jb, const int* body_a, const int* body_b, const int* flags,
                         const float* w, const float* rhs, const float* x0, float* x_out, int* status_out, float* f,
                         float* part, int part_len, int nj, int nb, int max_iters, float rel_tol, float abs_tol,
                         void* stream_ptr) {
  if (nj < 1 || nb < 1 || max_iters < 0) return (int)cudaErrorInvalidValue;
  Plan pl;
  cudaError_t err = plan(nj, pl);
  if (err != cudaSuccess) return (int)err;
  if (3 * pl.grid > part_len) return (int)cudaErrorInvalidValue;
  Params p = {ja, jb, body_a, body_b, flags, w, rhs, x0, x_out, status_out, f, part};
  p.nj = nj;
  p.nb = nb;
  p.max_iters = max_iters;
  p.grid = pl.grid;
  int gp = 32;
  while (gp < pl.grid) gp <<= 1;
  p.pchunk = gp / 32;
  p.rel_tol = rel_tol;
  p.abs_tol = abs_tol;
  const cudaStream_t stream = (cudaStream_t)stream_ptr;
  switch (pl.k) {
    case 1: err = launch<1>(p, stream); break;
    case 2: err = launch<2>(p, stream); break;
    case 4: err = launch<4>(p, stream); break;
    default: err = launch<8>(p, stream); break;
  }
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// The launch for nj slots: out = {slots a thread, blocks, blocks an SM the
// card holds, registers a thread}.
extern "C" int jcg_plan(int nj, int* out) {
  Plan pl;
  const cudaError_t err = plan(nj, pl);
  if (err != cudaSuccess) return (int)err;
  out[0] = pl.k;
  out[1] = pl.grid;
  out[2] = pl.per_sm;
  out[3] = pl.regs;
  return 0;
}
