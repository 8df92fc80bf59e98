// Banded box-box pair manifolds (Hopper, sm_90a).
//
// Replaces the TPU kernel pair_manifolds_banded
// (physics_tpu/ops/narrowphase_pallas.py:128, body _make_np_kernel :59-125).
// Plain version: physics_tpu_torch/ops/narrowphase_banded.py
// pair_manifolds_banded_plain; the manifold is boxbox.cuh's, which the box
// contact table (contact_table.cu) shares, so with -fmad=false kernel and
// plain version agree bit for bit.
//
// One thread per candidate lane j of the bucketed sweep's candidate array
// (or of one rank's slice of it, in the row-sharded step): tile t = j / tile
// reads its window base from `bases`, a device array either way (the static
// bucket-derived bases, or the slice's tile-min bases computed on the device,
// ops/narrowphase_banded.py _tile_min_bases), the lane's endpoints are the
// bodies of ranks base + la and base + lb of the rank-space body table (an
// out-of-band or empty endpoint, −1, reads an all-zero body, whose movable
// 0 kills every slot, as the TPU kernel's zero one-hot column did), the
// 15-axis manifold gives up to 8 points, and the kk deepest valid points are
// written pick by pick: point, depth (0 when inactive), source slot; then
// the lane's normal, friction, restitution and the two body ids.
//
// What bounds it on the H100: about 3.5k dependent f32 operations per lane
// and ~150 live registers, against 60 loaded floats; at the 4k pile's 32,768
// lanes that is ~0.11 G operations, so the kernel is latency- and
// occupancy-bound. 128 threads a block give 256 blocks for 132 SMs; rows are
// written lane-contiguous (coalesced). The TPU kernel's one-hot gather
// matmuls and hi/lo bf16 splits are not ported: endpoints are plain loads.

#include "boxbox.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kGeomRow0 = 24;    // narrow-phase block of the unified table

__global__ void __launch_bounds__(kThreads)
pair_manifolds_kernel(const float* __restrict__ geom_all, const int* __restrict__ bases,
                      const int* __restrict__ la_in, const int* __restrict__ lb_in, float* __restrict__ out,
                      int pp, int tile, int npad, int kk) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= pp) return;
  const float* geom = geom_all + (size_t)kGeomRow0 * npad;
  const int base = bases[j / tile];
  const int la = la_in[j];
  const int lb = lb_in[j];
  const Box A = la >= 0 ? load_box(geom, npad, base + la) : zero_box();
  const Box B = lb >= 0 ? load_box(geom, npad, base + lb) : zero_box();
  V3 pts[kCap];
  float depth[kCap];
  bool valid[kCap];
  V3 nrm;
  box_box_manifold(A, B, pts, depth, valid, nrm);
  const bool movable = (A.movable > 0.f) || (B.movable > 0.f);
  float score[kCap];
#pragma unroll
  for (int k = 0; k < kCap; ++k) score[k] = (valid[k] && movable) ? depth[k] : kBigNeg;

  const size_t P = (size_t)pp;
  float* o = out + j;
  for (int pick = 0; pick < kk; ++pick) {
    float best;
    int bidx;
    argmax(score, best, bidx);
    const bool act = best > 0.f;
    const V3 pt = select(bidx, pts);
    o[(5 * pick + 0) * P] = pt.x;
    o[(5 * pick + 1) * P] = pt.y;
    o[(5 * pick + 2) * P] = pt.z;
    o[(5 * pick + 3) * P] = act ? best : 0.f;
    o[(5 * pick + 4) * P] = (float)bidx;
#pragma unroll
    for (int k = 0; k < kCap; ++k) score[k] = bidx == k ? kBigNeg : score[k];
  }
  const int r0 = 5 * kk;
  o[(r0 + 0) * P] = nrm.x;
  o[(r0 + 1) * P] = nrm.y;
  o[(r0 + 2) * P] = nrm.z;
  o[(r0 + 3) * P] = sqrtf(A.fric * B.fric);
  o[(r0 + 4) * P] = fmaxf(A.rest, B.rest);
  o[(r0 + 5) * P] = A.id;
  o[(r0 + 6) * P] = B.id;
}

}  // namespace

extern "C" int np_pair_manifolds(const float* geom, const int* bases, const int* la, const int* lb, float* out,
                                 int pp, int tile, int npad, int kk, void* stream) {
  if (kk < 1 || kk > kCap || tile < 1 || pp % tile) return (int)cudaErrorInvalidValue;
  if (pp == 0) return 0;
  const int grid = (pp + kThreads - 1) / kThreads;
  pair_manifolds_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(geom, bases, la, lb, out, pp, tile, npad, kk);
  return (int)cudaGetLastError();
}
