// Fused bucket-aligned contact table for box piles (Hopper, sm_90a).
//
// Replaces the TPU kernel bucket_contact_table
// (physics_tpu/ops/contact_table.py:844, body _make_ct_kernel :166-747).
// Plain version: physics_tpu_torch/ops/contact_table.py
// bucket_contact_table_plain, whose narrow phase is ops/boxbox_batched.py;
// the kernel below and its box-box manifold (boxbox.cuh, shared with the
// banded pair-manifold kernel) compute the same operations in the same order.
//
// One block per bucket of 128 sweep ranks; a call builds the nb buckets from
// bucket0 on (all of them, or one rank's range in the row-sharded step), and
// its outputs are that range's blocks:
//   1. face-axis SAT prefilter over the bucket's `cap` candidate lanes;
//      survivors compacted, order preserved, into `cap2` lanes (block scan);
//   2. the 15-axis box-box manifold per surviving lane (one lane per thread),
//      and its `kk` deepest points;
//   3. up to `kg` ground corners per rank of the bucket;
//   4. a block-wide exclusive scan over the emissions in the reference's
//      order (pick-major over the pair lanes, then pick-major over the 128
//      ranks) gives each active contact its slot; slots >= ccap are dropped
//      and counted;
//   5. each slot's warm-start impulse: the previous step's contact of this
//      bucket with the same feature key (keys are unique per bucket).
//
// What bounds it on the H100: the manifold is ~2k dependent flops per lane
// with ~150 live registers, and the 4k pile has only 32 buckets, so the
// kernel is latency-bound on 32 SMs. The design keeps all per-contact
// intermediates in shared memory (no HBM round trip between phases) and
// reads geometry straight from the [48, NPAD] table by rank (L2-resident,
// 0.8 MB). Spreading a bucket over more blocks is later work.
//
// The TPU kernel's one-hot matmuls, hi/lo bf16 splits and triangular-matmul
// prefix sums are not ported: gathers are loads and the scan is a warp scan.

#include <cstdint>

#include "boxbox.cuh"

namespace {

constexpr int kBlock = 128;      // ranks per bucket
constexpr int kThreads = 256;
constexpr int kGeomRow0 = 24;    // narrow-phase block of the unified table

struct Smem {
  int* la2;      // [sat_cap]
  int* lb2;      // [sat_cap]
  int* slot;     // [E] activity flag, then slot (or -1)
  float* pt;     // [3 * E]
  float* dep;    // [E]
  float* ks;     // [E]
  float* lane_n; // [3 * sat_cap]
  float* ck;     // [ccap]
  float* ch;     // [ccap]
  float* prev;   // [5 * ccap]: ck, KH, λ0 xyz of the previous block
  int* warp_sums;// [32]
};

__host__ __device__ inline size_t smem_bytes(int sat_cap, int e, int ccap, bool warm) {
  size_t words = 2 * (size_t)sat_cap + (size_t)e + 5 * (size_t)e + 3 * (size_t)sat_cap + 2 * (size_t)ccap +
                 (warm ? 5 * (size_t)ccap : 0) + 32;
  return words * 4;
}

__device__ Smem carve(char* base, int sat_cap, int e, int ccap, bool warm) {
  Smem s;
  int* ip = reinterpret_cast<int*>(base);
  s.la2 = ip;
  s.lb2 = s.la2 + sat_cap;
  s.slot = s.lb2 + sat_cap;
  float* fp = reinterpret_cast<float*>(s.slot + e);
  s.pt = fp;
  s.dep = s.pt + 3 * (size_t)e;
  s.ks = s.dep + e;
  s.lane_n = s.ks + e;
  s.ck = s.lane_n + 3 * (size_t)sat_cap;
  s.ch = s.ck + ccap;
  s.prev = s.ch + ccap;
  s.warp_sums = reinterpret_cast<int*>(s.prev + (warm ? 5 * (size_t)ccap : 0));
  return s;
}

__global__ void __launch_bounds__(kThreads, 1)
contact_table_kernel(const float* __restrict__ geom_all, const int* __restrict__ la_in, const int* __restrict__ lb_in,
                     const float* __restrict__ pcols, float* __restrict__ table, float* __restrict__ meta,
                     float* __restrict__ warm, int nb, int bucket0, int cap, int cap2, int ccap, int kk, int kg,
                     int npad, int rows, float gh) {
  extern __shared__ __align__(16) char smem_raw[];
  const float* geom = geom_all + (size_t)kGeomRow0 * npad;  // the boxes' rows
  const int b = blockIdx.x;  // the bucket within the range: outputs and candidates
  const int tid = threadIdx.x;
  const int start = (bucket0 + b) * kBlock;  // its first rank
  const int sat_cap = cap2 ? cap2 : cap;
  const int n_pair_e = kk * sat_cap;
  const int e_tot = n_pair_e + kg * kBlock;
  const bool has_warm = pcols != nullptr;
  const size_t cp = (size_t)nb * ccap;
  Smem s = carve(smem_raw, sat_cap, e_tot, ccap, has_warm);

  // ---- phase 1: prefilter + order-preserving compaction to cap2 lanes ----
  int dropped2 = 0;
  if (cap2) {
    for (int i = tid; i < sat_cap; i += blockDim.x) s.la2[i] = s.lb2[i] = -1;
    __syncthreads();
    int offset = 0;
    for (int c0 = 0; c0 < cap; c0 += blockDim.x) {
      const int c = c0 + tid;
      int la = -1, lb = -1, keep = 0;
      if (c < cap) {
        la = la_in[(size_t)b * cap + c];
        lb = lb_in[(size_t)b * cap + c];
        if (la >= 0) {
          const Box ga = load_box(geom, npad, start + la);
          const Box gb = lb >= 0 ? load_box(geom, npad, start + lb) : zero_box();
          const float sep = face_sat_sep(sub(gb.p, ga.p), ga.r, gb.r, ga.h, gb.h);
          keep = (sep < 0.f) && ((ga.movable > 0.f) || (gb.movable > 0.f));
        }
      }
      int total;
      const int pos = offset + block_exclusive_scan(keep, s.warp_sums, total);
      if (keep && pos < cap2) {
        s.la2[pos] = la;
        s.lb2[pos] = lb;
      }
      offset += total;
    }
    dropped2 = offset > cap2 ? offset - cap2 : 0;
  } else {
    for (int i = tid; i < sat_cap; i += blockDim.x) {
      s.la2[i] = la_in[(size_t)b * cap + i];
      s.lb2[i] = lb_in[(size_t)b * cap + i];
    }
  }
  for (int j = tid; j < ccap; j += blockDim.x) {
    s.ck[j] = -2.f;  // inactive fresh slot key: KL = KS = KSGN = 0, ACT = 0
    s.ch[j] = 0.f;
  }
  __syncthreads();

  // ---- phase 2: manifolds and their kk deepest points ----
  for (int lane = tid; lane < sat_cap; lane += blockDim.x) {
    const int la = s.la2[lane];
    const int lb = s.lb2[lane];
    float score[kCap];
    V3 pts[kCap];
    V3 nrm = mk(0.f, 0.f, 0.f);
#pragma unroll
    for (int k = 0; k < kCap; ++k) score[k] = kBigNeg;
    if (la >= 0) {
      const Box ga = load_box(geom, npad, start + la);
      const Box gb = lb >= 0 ? load_box(geom, npad, start + lb) : zero_box();
      float depth[kCap];
      bool valid[kCap];
      box_box_manifold(ga, gb, pts, depth, valid, nrm);
      const bool movable = (ga.movable > 0.f) || (gb.movable > 0.f);
#pragma unroll
      for (int k = 0; k < kCap; ++k) score[k] = (valid[k] && movable) ? depth[k] : kBigNeg;
    } else {
#pragma unroll
      for (int k = 0; k < kCap; ++k) pts[k] = nrm;
    }
    s.lane_n[3 * lane + 0] = nrm.x;
    s.lane_n[3 * lane + 1] = nrm.y;
    s.lane_n[3 * lane + 2] = nrm.z;
    for (int pick = 0; pick < kk; ++pick) {
      float best;
      int bidx;
      argmax(score, best, bidx);
      const bool act = best > 0.f;
      const V3 pt = select(bidx, pts);
      const int e = pick * sat_cap + lane;
      s.slot[e] = act ? 1 : 0;
      s.pt[3 * e + 0] = pt.x;
      s.pt[3 * e + 1] = pt.y;
      s.pt[3 * e + 2] = pt.z;
      s.dep[e] = act ? best : 0.f;
      s.ks[e] = (float)bidx;
#pragma unroll
      for (int k = 0; k < kCap; ++k) score[k] = bidx == k ? kBigNeg : score[k];
    }
  }

  // ---- phase 3: ground corners of the bucket's own ranks ----
  if (kg > 0) {
    for (int r = tid; r < kBlock; r += blockDim.x) {
      const Box gl = load_box(geom, npad, start + r);
      const bool mv = gl.movable > 0.f;
      V3 pts[8];
      float gsc[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float sx = (c & 4) ? 1.f : -1.f;
        const float sy = (c & 2) ? 1.f : -1.f;
        const float sz = (c & 1) ? 1.f : -1.f;
        const float wx = sx * gl.h.x, wy = sy * gl.h.y, wz = sz * gl.h.z;
        const float cx = gl.p.x + gl.r[0] * wx + gl.r[1] * wy + gl.r[2] * wz;
        const float cy = gl.p.y + gl.r[3] * wx + gl.r[4] * wy + gl.r[5] * wz;
        const float cz = gl.p.z + gl.r[6] * wx + gl.r[7] * wy + gl.r[8] * wz;
        pts[c] = mk(cx, cy, cz);
        const float d = gh - cy;
        gsc[c] = (mv && (d > 0.f)) ? d : kBigNeg;
      }
      for (int pick = 0; pick < kg; ++pick) {
        float best;
        int bidx;
        argmax(gsc, best, bidx);
        const bool act = best > 0.f;
        const V3 pt = select(bidx, pts);
        const int e = n_pair_e + pick * kBlock + r;
        s.slot[e] = act ? 1 : 0;
        s.pt[3 * e + 0] = pt.x;
        s.pt[3 * e + 1] = pt.y;
        s.pt[3 * e + 2] = pt.z;
        s.dep[e] = act ? best : 0.f;
        s.ks[e] = (float)bidx;
#pragma unroll
        for (int c = 0; c < 8; ++c) gsc[c] = bidx == c ? kBigNeg : gsc[c];
      }
    }
  }
  __syncthreads();

  // ---- phase 4: stable compaction of the emissions into ccap slots ----
  int n_act = 0;
  for (int e0 = 0; e0 < e_tot; e0 += blockDim.x) {
    const int e = e0 + tid;
    const int flag = e < e_tot ? s.slot[e] : 0;
    int total;
    const int pos = n_act + block_exclusive_scan(flag, s.warp_sums, total);
    if (e < e_tot) s.slot[e] = flag ? pos : -1;
    n_act += total;
  }
  __syncthreads();

  float* out = table + (size_t)b * ccap;
  for (int e = tid; e < e_tot; e += blockDim.x) {
    const int sl = s.slot[e];
    if (sl < 0 || sl >= ccap) continue;
    float v[32];
    const V3 pt = mk(s.pt[3 * e], s.pt[3 * e + 1], s.pt[3 * e + 2]);
    v[0] = pt.x;
    v[1] = pt.y;
    v[2] = pt.z;
    v[6] = s.dep[e];
    v[9] = 1.f;
    v[15] = s.ks[e];
    V3 a_loc, b_loc, n_loc;
    if (e < n_pair_e) {
      const int lane = e % sat_cap;
      const int la = s.la2[lane];
      const int lb = s.lb2[lane];
      const Box ga = load_box(geom, npad, start + la);
      const Box gb = lb >= 0 ? load_box(geom, npad, start + lb) : zero_box();
      const V3 n = mk(s.lane_n[3 * lane], s.lane_n[3 * lane + 1], s.lane_n[3 * lane + 2]);
      v[3] = n.x;
      v[4] = n.y;
      v[5] = n.z;
      v[7] = sqrtf(ga.fric * gb.fric);
      v[8] = fmaxf(ga.rest, gb.rest);
      const int ia = (int)ga.id, ib = (int)gb.id;
      v[10] = (float)(ia > ib ? ia : ib);
      v[11] = (float)(ia < ib ? ia : ib);
      v[12] = 0.f;
      v[13] = (float)(start + la);
      v[14] = (float)(start + lb + 1);
      a_loc = t_apply(ga.r, sub(pt, ga.p));
      b_loc = t_apply(gb.r, sub(pt, gb.p));
      n_loc = t_apply(ga.r, n);
    } else {
      const int r = (e - n_pair_e) % kBlock;
      const Box gl = load_box(geom, npad, start + r);
      v[3] = 0.f;
      v[4] = 1.f;
      v[5] = 0.f;
      v[7] = gl.fric;
      v[8] = gl.rest;
      v[10] = gl.id;
      v[11] = 0.f;
      v[12] = 1.f;
      v[13] = (float)(start + r);
      v[14] = 0.f;
      a_loc = t_apply(gl.r, sub(pt, gl.p));
      b_loc = pt;
      n_loc = mk(gl.r[3], gl.r[4], gl.r[5]);
    }
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
    for (int k = 0; k < rows; ++k) out[(size_t)k * cp + sl] = v[k];
    s.ck[sl] = v[10] + 65536.0f * (2.0f * v[15] + v[12]) + 2.0f * (v[9] - 1.0f);
    s.ch[sl] = v[11];
  }
  const int kept = n_act < ccap ? n_act : ccap;
  for (int j = kept + tid; j < ccap; j += blockDim.x)
    for (int k = 0; k < rows; ++k) out[(size_t)k * cp + j] = 0.f;

  // ---- meta: dropped, active, prefilter drops, window overflow (0) ----
  for (int i = tid; i < 8 * kBlock; i += blockDim.x) {
    const int r = i / kBlock, c = i % kBlock;
    float val = 0.f;
    if (r == 0 && c == 0) val = (float)(n_act > ccap ? n_act - ccap : 0);
    if (r == 0 && c == 1) val = (float)n_act;
    if (r == 0 && c == 2) val = (float)dropped2;
    meta[(size_t)r * nb * kBlock + (size_t)b * kBlock + c] = val;
  }
  if (!has_warm) return;

  // ---- phase 5: warm start by key match within the bucket ----
  for (int i = tid; i < ccap; i += blockDim.x) {
    const float* pc = pcols + ((size_t)b * ccap + i) * 8;
    s.prev[i] = pc[0];
    s.prev[ccap + i] = pc[1];
    s.prev[2 * ccap + i] = pc[4];
    s.prev[3 * ccap + i] = pc[5];
    s.prev[4 * ccap + i] = pc[6];
  }
  __syncthreads();
  float* wout = warm + (size_t)b * ccap;
  for (int j = tid; j < ccap; j += blockDim.x) {
    const float ck = s.ck[j], ch = s.ch[j];
    float l0 = 0.f, l1 = 0.f, l2 = 0.f;
    for (int i = 0; i < ccap; ++i) {
      if (fabsf(s.prev[i] - ck) < 0.5f && fabsf(s.prev[ccap + i] - ch) < 0.5f) {
        l0 = s.prev[2 * ccap + i];
        l1 = s.prev[3 * ccap + i];
        l2 = s.prev[4 * ccap + i];
        break;
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

extern "C" int ct_bucket_contact_table(const float* geom, const int* la, const int* lb, const float* pcols,
                                       float* table, float* meta, float* warm, int nb, int bucket0, int cap,
                                       int cap2, int ccap, int kk, int kg, int npad, int rows, float gh,
                                       void* stream) {
  if (kk > kCap || kg > 8 || rows > 32 || (cap2 && cap2 > cap) || bucket0 < 0 ||
      (size_t)(bucket0 + nb + 2) * kBlock > (size_t)npad)
    return (int)cudaErrorInvalidValue;
  const int sat_cap = cap2 ? cap2 : cap;
  const int e_tot = kk * sat_cap + kg * kBlock;
  const size_t smem = smem_bytes(sat_cap, e_tot, ccap, pcols != nullptr);
  cudaError_t err = cudaFuncSetAttribute(contact_table_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  contact_table_kernel<<<nb, kThreads, smem, (cudaStream_t)stream>>>(geom, la, lb, pcols, table, meta, warm, nb,
                                                                     bucket0, cap, cap2, ccap, kk, kg, npad, rows,
                                                                     gh);
  return (int)cudaGetLastError();
}

// Text of a cudaError_t returned by any entry point of the library.
extern "C" const char* pk_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }
