// The sweep broad phase (Hopper, sm_90a): replaces sweep_window_masks (kernel
// 2.1, physics_tpu/ops/sweep_pallas.py:61, pallas_call :91) and, in the same
// launch, the bucketed compaction its consumer does with a segmented sort
// (physics_tpu/ops/broadphase.py:242 sweep_candidates_bucketed). Plain
// versions: physics_tpu_torch/ops/sweep_kernel.py (sweep_window_masks_plain,
// bucketed_candidates_plain).
//
// For bodies sorted by AABB min-x, rank i is tested against ranks i+1 … i+k:
// hit(i, d) = i+d < n, the two boxes overlap on all three axes (each
// max(lo) <= min(hi) spelled as its four compares, which a NaN fails as
// torch.maximum's NaN does), and both are collidable; last(i) = i+k < n,
// rank i+k's min-x starts before i's max-x and i is collidable.
//
// One kernel, two modes:
//   - masks: the AABBs and flags come sorted; a block takes 128 ranks and
//     writes mask [N, k] and last [N] (what the TPU kernel computed);
//   - candidates: a cluster of kSplit blocks takes a bucket of `block`
//     ranks. Each block gathers the bucket's block + k sorted AABBs through
//     `order` into its shared memory and tests its share of the bucket's
//     tests, flattened as f = r·k + (d − 1): a warp's ballot is the hit mask
//     of 32 consecutive f (a rank's k tests may straddle two warps), kept in
//     shared memory, one bit a test. A block scan over the words' counts and
//     the other shares' counts (read across the cluster from their shared
//     memory) give each test its lane: the h hits of the bucket in f order,
//     then its misses in f order (the reference's sort key: hit flag in bit
//     31, f below), then slot 0 where block·k < cap. Lanes from cap on are
//     dropped.
// The call's overflow (the window-edge ranks and the hits beyond each
// bucket's cap) is summed by the buckets into a device counter; the last
// bucket to finish writes it out and resets the counter, so a call is one
// capturable launch with no host read.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kSplit = 4;        // blocks (a cluster) a bucket in the candidates mode
constexpr int kMaskBlock = 128;  // ranks a block in the masks mode
constexpr int kShapeNone = 0;    // state.SHAPE_NONE

struct Sweep {
  const int* order;            // sorted rank → body (candidates) or nullptr
  const float* aabbs;          // [N, 2, 3] by body (candidates) or by rank
  const int* stype;            // [N] shape type by body (candidates)
  const unsigned char* coll;   // [N] collidable flags by rank (masks)
  int n, k, block, cap;
};

struct Out {
  unsigned char* mask;  // masks: [N, k]; candidates: [NB·cap]
  unsigned char* last;  // masks: [N]
  int* body_a;          // candidates: [NB·cap] each
  int* body_b;
  int* rank_a;
  int* rank_b;
  int* overflow;        // candidates: []
};

__device__ int g_overflow;       // the blocks' overflow so far
__device__ unsigned int g_done;  // blocks done; the last one wraps it to 0

// The sorted ranks base … base + R − 1 of a block: AABB rows lo xyz, hi xyz
// (SoA, R each), the body id and the collidable flag (0 past n).
struct Ranks {
  float* box;   // [6][R]
  int* body;    // [R]
  int* coll;    // [R]
  int r;
};

__device__ __forceinline__ bool hit(const Ranks& s, int i, int j) {
  const float* b = s.box;
  const int r = s.r;
  bool ok = s.coll[i] && s.coll[j];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float lo_i = b[a * r + i], hi_i = b[(3 + a) * r + i];
    const float lo_j = b[a * r + j], hi_j = b[(3 + a) * r + j];
    ok = ok && (lo_i <= hi_i) && (lo_j <= hi_j) && (lo_i <= hi_j) && (lo_j <= hi_i);
  }
  return ok;
}

// Masks mode: a block of kMaskBlock ranks. Candidates mode: a cluster of
// kSplit blocks a bucket, block q of the cluster testing the q-th share of
// the bucket's words; the shares' hit counts cross the cluster through
// distributed shared memory.
template <bool kMasks>
__global__ void __launch_bounds__(kThreads) sweep_kernel(Sweep p, Out o) {
  extern __shared__ __align__(16) int smem[];
  __shared__ int warp_sums[32];
  __shared__ int share_hits;
  const int tid = threadIdx.x;
  const int k = p.k, n = p.n;
  const int block = kMasks ? kMaskBlock : p.block;
  const int bucket = kMasks ? blockIdx.x : blockIdx.x / kSplit;
  const int q = kMasks ? 0 : blockIdx.x % kSplit;   // the cluster's block rank
  const int base = bucket * block;
  const int rows = min(block, n - base);   // real ranks of the bucket
  const int t_all = block * k;             // tests of a bucket
  const int words = (t_all + 31) / 32;
  const int w_share = (words + kSplit - 1) / kSplit;
  const int w_lo = kMasks ? 0 : min(q * w_share, words);
  const int w_hi = kMasks ? words : min(w_lo + w_share, words);
  const int f_lo = 32 * w_lo, f_hi = min(32 * w_hi, t_all);

  Ranks s;
  s.r = block + k;
  s.box = reinterpret_cast<float*>(smem);
  s.body = smem + 6 * s.r;
  s.coll = s.body + s.r;
  unsigned* bits = reinterpret_cast<unsigned*>(s.coll + s.r);  // [w_share]
  int* pre = reinterpret_cast<int*>(bits + w_share);           // [w_share]

  // ---- the bucket's ranks into shared memory ----
  for (int t = tid; t < s.r; t += blockDim.x) {
    const int rank = base + t;
    int body = rank, c = 0;
    float v[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (rank < n) {
      if (!kMasks) body = p.order[rank];
      const float* a = p.aabbs + (size_t)body * 6;
#pragma unroll
      for (int u = 0; u < 6; ++u) v[u] = a[u];
      c = kMasks ? (int)p.coll[rank] : (int)(p.stype[body] != kShapeNone);
    }
#pragma unroll
    for (int u = 0; u < 6; ++u) s.box[u * s.r + t] = v[u];
    s.body[t] = body;
    s.coll[t] = c;
  }
  __syncthreads();

  // ---- the window-edge flags (block 0 of a cluster) ----
  int edge = 0;
  for (int r0 = 0; q == 0 && r0 < block; r0 += blockDim.x) {
    const int r = r0 + tid;
    const bool last = r < rows && base + r + k < n && s.box[r + k] <= s.box[3 * s.r + r] && s.coll[r];
    if (kMasks && r < rows) o.last[base + r] = last;
    edge += __syncthreads_count(last);
  }

  // ---- the tests, f = r·k + (d − 1): masks out, or one bit each ----
  const int t_rows = rows * k;
  for (int f0 = f_lo; f0 < f_hi; f0 += blockDim.x) {
    const int f = f0 + tid;
    const int r = f / k, d = f - r * k + 1;
    const bool h = f < t_rows && f < f_hi && base + r + d < n && hit(s, r, r + d);
    if (kMasks) {
      if (f < t_rows) o.mask[(size_t)base * k + f] = h;
    } else {
      const unsigned b = __ballot_sync(0xffffffffu, h);
      if ((tid & 31) == 0 && f < f_hi) bits[(f >> 5) - w_lo] = b;
    }
  }
  if constexpr (kMasks) {
    return;
  } else {
    __syncthreads();

    // ---- hits before each word of the share: a block scan ----
    int hits = 0;
    for (int w0 = w_lo; w0 < w_hi; w0 += blockDim.x) {
      const int w = w0 + tid;
      int total;
      const int off = block_exclusive_scan(w < w_hi ? __popc(bits[w - w_lo]) : 0, warp_sums, total);
      if (w < w_hi) pre[w - w_lo] = hits + off;
      hits += total;
    }
    // ---- the bucket's hits before the share, and in all ----
    cg::cluster_group cluster = cg::this_cluster();
    if (tid == 0) share_hits = hits;
    cluster.sync();
    int before = 0, bucket_hits = 0;
    for (int r = 0; r < kSplit; ++r) {
      const int x = *cluster.map_shared_rank(&share_hits, r);
      before += r < q ? x : 0;
      bucket_hits += x;
    }
    cluster.sync();  // every block has read the others' counts

    // ---- every test of the share to its lane: hits first, then misses,
    // in f order; block 0 also fills the lanes past block·k with slot 0 ----
    const int cap = p.cap;
    const size_t lane0 = (size_t)bucket * cap;
    const int f_stop = q == 0 ? max(f_hi, cap) : f_hi;
    for (int f0 = f_lo; f0 < f_stop; f0 += blockDim.x) {
      const int f = f0 + tid;
      int lane, slot;
      bool live;
      if (f < f_hi) {
        const unsigned w = bits[(f >> 5) - w_lo];
        const int below = before + pre[(f >> 5) - w_lo] + __popc(w & ((1u << (f & 31)) - 1u));
        live = (w >> (f & 31)) & 1u;
        lane = live ? below : bucket_hits + f - below;
        slot = f;
      } else if (f >= t_all && f < cap) {
        lane = f;  // block·k < cap: the rest of the lanes hold slot 0
        live = false;
        slot = 0;
      } else {
        continue;
      }
      if (lane >= cap) continue;
      const int ra = min(base + slot / k, n - 1);
      const int rb = min(ra + 1 + slot % k, n - 1);
      o.rank_a[lane0 + lane] = ra;
      o.rank_b[lane0 + lane] = rb;
      o.body_a[lane0 + lane] = s.body[ra - base];
      o.body_b[lane0 + lane] = s.body[rb - base];
      o.mask[lane0 + lane] = live;
    }

    // ---- the overflow: the last bucket done writes the sum and resets ----
    if (q == 0 && tid == 0) {
      atomicAdd(&g_overflow, edge + max(bucket_hits - cap, 0));
      __threadfence();
      const unsigned nb = gridDim.x / kSplit;
      if (atomicInc(&g_done, nb - 1) == nb - 1) *o.overflow = atomicExch(&g_overflow, 0);
    }
  }
}

size_t smem_bytes(int block, int k, int split) {
  const size_t r = (size_t)block + k;
  const size_t words = ((size_t)block * k + 31) / 32;
  return 4 * (8 * r + 2 * ((words + split - 1) / split));
}

template <bool kMasks>
cudaError_t launch(const Sweep& p, const Out& o, int grid, int block, cudaStream_t st) {
  const int split = kMasks ? 1 : kSplit;
  const size_t smem = smem_bytes(block, p.k, split);
  cudaError_t err = cudaFuncSetAttribute(sweep_kernel<kMasks>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid * split);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = kMasks ? 0 : 1;
  err = cudaLaunchKernelEx(&cfg, sweep_kernel<kMasks>, p, o);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// Masks mode: aabb_sorted [N, 2, 3], coll_sorted [N] (0/1) → mask [N, k],
// last [N] (0/1).
extern "C" int sw_window_masks(const float* aabb_sorted, const unsigned char* coll_sorted, unsigned char* mask,
                               unsigned char* last, int n, int k, void* stream) {
  if (n < 2 || k < 1 || k >= n) return (int)cudaErrorInvalidValue;
  Sweep p = {};
  p.aabbs = aabb_sorted;
  p.coll = coll_sorted;
  p.n = n;
  p.k = k;
  Out o = {};
  o.mask = mask;
  o.last = last;
  return (int)launch<true>(p, o, (n + kMaskBlock - 1) / kMaskBlock, kMaskBlock, (cudaStream_t)stream);
}

// Candidates mode: order [N] (sorted rank → body), aabbs [N, 2, 3] and stype
// [N] by body → each bucket's cap lanes (body_a, body_b, mask, rank_a,
// rank_b, each [NB·cap]) and overflow [], NB = ceil(n / block). One call at
// a time a device: the blocks share one overflow counter.
extern "C" int sw_bucketed_candidates(const int* order, const float* aabbs, const int* stype, int* body_a,
                                      int* body_b, unsigned char* mask, int* rank_a, int* rank_b, int* overflow,
                                      int n, int k, int block, int cap, void* stream) {
  if (n < 2 || k < 1 || k >= n || block < 1 || cap < 1) return (int)cudaErrorInvalidValue;
  Sweep p = {};
  p.order = order;
  p.aabbs = aabbs;
  p.stype = stype;
  p.n = n;
  p.k = k;
  p.block = block;
  p.cap = cap;
  Out o = {};
  o.mask = mask;
  o.body_a = body_a;
  o.body_b = body_b;
  o.rank_a = rank_a;
  o.rank_b = rank_b;
  o.overflow = overflow;
  return (int)launch<false>(p, o, (n + block - 1) / block, block, (cudaStream_t)stream);
}
