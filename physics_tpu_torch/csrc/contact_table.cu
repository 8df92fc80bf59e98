// Fused bucket-aligned contact table for box piles and packed envs
// (Hopper, sm_90a).
//
// Replaces the TPU kernel bucket_contact_table
// (physics_tpu/ops/contact_table.py:844, body _make_ct_kernel :166-747), all
// four of its modes. Plain version: physics_tpu_torch/ops/contact_table.py
// bucket_contact_table_plain, whose narrow phase is ops/boxbox_batched.py;
// the kernels below and their box-box manifold (boxbox.cuh, shared with the
// banded pair-manifold kernel) compute the same operations in the same order.
//
// A call builds the nb buckets of 128 ranks from bucket0 on (all of them, or
// one rank's range in the row-sharded step); its outputs are that range's
// blocks. Five launches on the caller's stream:
//   1. lanes (a block per bucket): with bp_k > 0, the in-kernel broad phase:
//      the window AABBs (|R|·half extents) of the bucket's 128 + bp_k ranks
//      in shared memory, a thread per raw pair (a, a + d), d-major, tested
//      (AABB overlap, both live, one movable; with env_k both in one env) and
//      compacted, order preserved, by the block scan; the first `cap`
//      survivors are the stage-1 lanes, and the same scan counts the ranks
//      still overlapping at d = bp_k. With cap2, then, the face-axis SAT
//      prefilter on each stage-1 (or candidate) lane, its survivors
//      compacted into `cap2` lanes. The SAT lanes go to scratch, with the
//      lane drops (raw → cap, then cap → cap2);
//   2. pairs (a thread per SAT lane, and a block of 128 for the bucket's
//      ranks): the 15-axis box-box manifold and its kk deepest points, a pick
//      active when its depth is > 0; each active pick's point and depth, the
//      lane's normal and one word (the picks' activity bits and manifold
//      slots) to scratch; a rank's kg ground corners likewise in one word
//      (the row writer recomputes a corner from its id). Each warp's ballot
//      of pick p is the activity mask of 32 consecutive emissions in the
//      reference's order (pick-major over the lanes, then pick-major over
//      the 128 ranks);
//   3. scan (a block per bucket): the stable scan over those masks gives
//      each active emission its slot (slots >= ccap are dropped and
//      counted); the meta counters; the previous keys compacted for 5;
//   4. rows (a thread per slot): the slot's table rows and warm key; slots
//      beyond the count zeroed;
//   5. warm (common.cuh warm_match_kernel, shared with the hull table; a warp
//      per 8 slots): each slot's warm-start impulse from the first previous
//      slot of its bucket with the same feature key.
// With a gate (the displacement-gated refresh), a bucket whose gate is 0
// skips 1 and 2, writes zero meta in 3, copies its persisted block in 4
// (16-byte vectors, a warp a row) with its keys, and 5 matches the copy,
// which carries each slot's λ by identity.
//
// What bounds it on the H100: the one-block-a-bucket kernel this replaces
// spent 80% of the 4k pile's call and 36% of the packed envs' in its warm
// match, 8 warps scanning 768 slots in turn (tools/table_split.py); its
// manifold ran 2–4 rounds of 8 warps an SM on 32 (pile) or 132 SMs, its scan
// 32 rounds of a block scan over 8,192 emissions, and its rows 3 rounds of a
// block. Here the manifold, the rows, the copy and the warm match run as
// many threads as the work has, on every SM; what stays a block a bucket is
// order: the two compactions and the slot scan, which walks one
// 32-bit mask per 32 emissions. A manifold is ~3.5k dependent f32
// operations on one thread, so latency bounds a fired call's manifold
// launch; the passed-through buckets' copy is bound by bytes.
//
// The TPU kernel's one-hot matmuls, hi/lo bf16 splits, strided lane rolls and
// triangular-matmul prefix sums are not ported: gathers are loads and the
// scans are warp scans and ballots.

#include <cstdint>

#include "boxbox.cuh"

namespace {

struct box_table_warm;  // names 2.2's instance of the shared warm match

constexpr int kBlock = 128;         // ranks per bucket
constexpr int kLaneThreads = 512;   // lanes: a bucket's compactions
constexpr int kPairThreads = 128;   // pairs: SAT lanes (or ranks) a block
constexpr int kScanThreads = 1024;  // scan: a bucket's 32-emission groups
constexpr int kRowThreads = 128;    // rows: slots a block
constexpr int kGeomRow0 = 24;       // narrow-phase block of the unified table

struct Dims {
  int nb, bucket0, cap, cap2, sat_cap, ccap, kk, kg, npad, rows, bp_k, env_k;
  int n_pair_e;  // pair emissions a bucket, kk · sat_cap
  int groups;    // 32-emission groups a bucket, (kk · sat_cap + kg · 128) / 32
  float gh;
};

// Scratch carved from one int32 buffer, in 4-byte words.
struct Scratch {
  int* stage1;          // [2, nb, cap] the in-kernel broad phase's lanes, before the prefilter
  int* lanes;           // [2, nb, sat_cap] SAT lanes (window-local ranks A, B; −1 empty)
  int* info;            // [2, nb] lane drops, window-edge ranks
  unsigned* lane_word;  // [nb, sat_cap] bit p: pick p active; bits 8 + 3p: its manifold slot
  float* lane_n;        // [3, nb, sat_cap] the lane's normal
  float* em;            // [4, nb, n_pair_e] active pair emissions: point xyz, depth
  unsigned* gnd_word;   // [nb, 128] the same word for a rank's ground picks
  unsigned* group;      // [nb, groups] activity mask of each 32 emissions
  int* nact;            // [nb] active emissions (ccap for a passed-through bucket)
  int* slot_em;         // [nb, ccap] the emission of each live slot
  float* keys;          // [2, nb·ccap] warm key (ck, KH) of each slot
  float2* prev;         // [nb·ccap] previous keys (ck, KH), compact_prev_keys
  int* n_prev;          // [nb] previous slots the warm match scans
  size_t words;
};

__host__ __device__ inline size_t round4(size_t x) { return (x + 3) / 4 * 4; }

__host__ __device__ inline Scratch carve_scratch(int* base, const Dims& d) {
  const size_t lanes = (size_t)d.nb * d.sat_cap;
  const size_t slots = (size_t)d.nb * d.ccap;
  const size_t sizes[13] = {2 * lanes, 2 * (size_t)d.nb, lanes, 3 * lanes, 4 * (size_t)d.nb * d.n_pair_e,
                            (size_t)d.nb * kBlock, (size_t)d.nb * d.groups, (size_t)d.nb, slots, 2 * slots,
                            2 * slots, (size_t)d.nb, 2 * (size_t)d.nb * d.cap};
  int* p[13];
  size_t off = 0;
  for (int k = 0; k < 13; ++k) {
    p[k] = base ? base + off : nullptr;
    off += round4(sizes[k]);
  }
  Scratch s;
  s.lanes = p[0];
  s.info = p[1];
  s.lane_word = reinterpret_cast<unsigned*>(p[2]);
  s.lane_n = reinterpret_cast<float*>(p[3]);
  s.em = reinterpret_cast<float*>(p[4]);
  s.gnd_word = reinterpret_cast<unsigned*>(p[5]);
  s.group = reinterpret_cast<unsigned*>(p[6]);
  s.nact = p[7];
  s.slot_em = p[8];
  s.keys = reinterpret_cast<float*>(p[9]);
  s.prev = reinterpret_cast<float2*>(p[10]);
  s.n_prev = p[11];
  s.stage1 = p[12];
  s.words = off;
  return s;
}

__device__ __forceinline__ bool passed_through(const int* gate, int b) { return gate != nullptr && gate[b] <= 0; }

// Corner c (bit 2: +x, bit 1: +y, bit 0: +z) of box gl in world.
__device__ __forceinline__ V3 box_corner(const Box& gl, int c) {
  const float sx = (c & 4) ? 1.f : -1.f;
  const float sy = (c & 2) ? 1.f : -1.f;
  const float sz = (c & 1) ? 1.f : -1.f;
  const float wx = sx * gl.h.x, wy = sy * gl.h.y, wz = sz * gl.h.z;
  return mk(gl.p.x + gl.r[0] * wx + gl.r[1] * wy + gl.r[2] * wz,
            gl.p.y + gl.r[3] * wx + gl.r[4] * wy + gl.r[5] * wz,
            gl.p.z + gl.r[6] * wx + gl.r[7] * wy + gl.r[8] * wz);
}

// The warm key of a slot from its table rows (ACT, KL, KSGN, KS).
__device__ __forceinline__ float warm_key(float act, float kl, float ksgn, float ks) {
  return kl + 65536.0f * (2.0f * ks + ksgn) + 2.0f * (act - 1.0f);
}

// ---------------------------------------------------------------------------
// 1. the SAT lanes: in-kernel broad phase and prefilter, order preserved
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kLaneThreads)
box_table_lanes_kernel(const float* __restrict__ geom_all, const int* __restrict__ la_in,
                       const int* __restrict__ lb_in, const int* __restrict__ gate, Scratch sc, Dims d) {
  __shared__ float box[8 * 2 * kBlock];  // window AABB min xyz, max xyz, live, movable
  __shared__ int warp_sums[32];
  const int b = blockIdx.x;
  if (passed_through(gate, b)) return;
  const float* geom = geom_all + (size_t)kGeomRow0 * d.npad;
  const int tid = threadIdx.x;
  const int start = (d.bucket0 + b) * kBlock;
  int* la2 = sc.lanes + (size_t)b * d.sat_cap;
  int* lb2 = sc.lanes + ((size_t)d.nb + b) * d.sat_cap;
  if (!d.bp_k && !d.cap2) {  // the candidate lanes are the SAT lanes
    for (int i = tid; i < d.sat_cap; i += blockDim.x) {
      la2[i] = la_in[(size_t)b * d.cap + i];
      lb2[i] = lb_in[(size_t)b * d.cap + i];
    }
    if (tid == 0) sc.info[b] = sc.info[d.nb + b] = 0;
    return;
  }
  const int* src_a;  // the prefilter's lanes: candidates, or stage-1 lanes
  const int* src_b;
  int n_src = d.cap;
  int n1 = 0, winovf = 0;  // raw survivors, window-edge ranks
  if (!d.bp_k) {
    src_a = la_in + (size_t)b * d.cap;
    src_b = lb_in + (size_t)b * d.cap;
  } else {
    for (int l = tid; l < kBlock + d.bp_k; l += blockDim.x) {
      const Box g = load_box(geom, d.npad, start + l);
      float* bx = box + 8 * l;
      const float hv[3] = {g.h.x, g.h.y, g.h.z};
      const float pv[3] = {g.p.x, g.p.y, g.p.z};
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        float e = fabsf(g.r[3 * c]) * hv[0];
        e = e + fabsf(g.r[3 * c + 1]) * hv[1];
        e = e + fabsf(g.r[3 * c + 2]) * hv[2];
        bx[c] = pv[c] - e;
        bx[3 + c] = pv[c] + e;
      }
      bx[6] = geom[19 * (size_t)d.npad + start + l];  // is_shape (live)
      bx[7] = g.movable;
    }
    __syncthreads();
    // the raw pairs, d-major; the first cap survivors are the stage-1 lanes
    int* la1 = d.cap2 ? sc.stage1 + (size_t)b * d.cap : la2;
    int* lb1 = d.cap2 ? sc.stage1 + ((size_t)d.nb + b) * d.cap : lb2;
    const int items = d.bp_k * kBlock;
    for (int q0 = 0; q0 < items; q0 += blockDim.x) {
      const int q = q0 + tid;
      int raw = 0, ov = 0, a = 0, bb = 0;
      if (q < items) {
        const int dd = q / kBlock + 1;
        a = q % kBlock;
        bb = a + dd;
        const float* A = box + 8 * a;
        const float* B = box + 8 * bb;
        const bool x_ov = B[0] <= A[3];
        bool k = x_ov;
#pragma unroll
        for (int c = 0; c < 3; ++c) k = k && (fmaxf(A[c], B[c]) <= fminf(A[3 + c], B[3 + c]));
        const bool live = (A[6] > 0.f) && (B[6] > 0.f);
        k = k && live && ((A[7] > 0.f) || (B[7] > 0.f));
        if (d.env_k) {
          k = k && ((a % d.env_k) + dd < d.env_k);
        } else {
          ov = (dd == d.bp_k) && x_ov && live;
        }
        raw = k;
      }
      // one scan for both counts: survivors in the low 16 bits, window-edge
      // ranks above (each at most blockDim.x a round)
      int total;
      const int pos = n1 + (block_exclusive_scan(raw | (ov << 16), warp_sums, total) & 0xffff);
      if (raw && pos < d.cap) {
        la1[pos] = a;
        lb1[pos] = bb;
      }
      n1 += total & 0xffff;
      winovf += total >> 16;
    }
    src_a = la1;
    src_b = lb1;
    n_src = min(n1, d.cap);
    __syncthreads();  // the stage-1 lanes, for the prefilter's other threads
  }
  // the prefilter on each stage-1 (or candidate) lane, its survivors
  // compacted into cap2 lanes
  int n2 = 0;
  for (int c0 = 0; d.cap2 && c0 < n_src; c0 += blockDim.x) {
    const int c = c0 + tid;
    int la = -1, lb = -1, pass = 0;
    if (c < n_src) {
      la = src_a[c];
      lb = src_b[c];
      if (la >= 0) {
        const Box ga = load_box(geom, d.npad, start + la);
        const Box gb = lb >= 0 ? load_box(geom, d.npad, start + lb) : zero_box();
        const float sep = face_sat_sep(sub(gb.p, ga.p), ga.r, gb.r, ga.h, gb.h);
        pass = (sep < 0.f) && ((ga.movable > 0.f) || (gb.movable > 0.f));
      }
    }
    int total;
    const int pos = n2 + block_exclusive_scan(pass, warp_sums, total);
    if (pass && pos < d.cap2) {
      la2[pos] = la;
      lb2[pos] = lb;
    }
    n2 += total;
  }
  const int n_sat = d.cap2 ? min(n2, d.cap2) : n_src;
  for (int i = n_sat + tid; i < d.sat_cap; i += blockDim.x) la2[i] = lb2[i] = -1;
  if (tid == 0) {
    // raw → cap drops, then cap → cap2 drops
    sc.info[b] = (n1 > d.cap ? n1 - d.cap : 0) + (d.cap2 && n2 > d.cap2 ? n2 - d.cap2 : 0);
    sc.info[d.nb + b] = winovf;
  }
}

// ---------------------------------------------------------------------------
// 2. manifolds and ground corners: a thread per SAT lane, a thread per rank
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kPairThreads)
box_table_pairs_kernel(const float* __restrict__ geom_all, const int* __restrict__ gate, Scratch sc, Dims d) {
  const int b = blockIdx.y;
  if (passed_through(gate, b)) return;
  const float* geom = geom_all + (size_t)kGeomRow0 * d.npad;
  const int start = (d.bucket0 + b) * kBlock;
  const int lane_blocks = d.kk ? d.sat_cap / kPairThreads : 0;
  const int wl = threadIdx.x & 31;
  unsigned* gm = sc.group + (size_t)b * d.groups;
  unsigned word = 0;  // bit p: pick p active; bits 8 + 3p: its slot
  if ((int)blockIdx.x < lane_blocks) {
    const int lane = blockIdx.x * kPairThreads + threadIdx.x;
    const size_t li = (size_t)b * d.sat_cap + lane;
    const int la = sc.lanes[li];
    const int lb = sc.lanes[(size_t)d.nb * d.sat_cap + li];
    if (la >= 0) {
      const Box ga = load_box(geom, d.npad, start + la);
      const Box gb = lb >= 0 ? load_box(geom, d.npad, start + lb) : zero_box();
      V3 pts[kCap];
      float depth[kCap];
      bool valid[kCap];
      V3 nrm;
      box_box_manifold(ga, gb, pts, depth, valid, nrm);
      const bool movable = (ga.movable > 0.f) || (gb.movable > 0.f);
      float score[kCap];
#pragma unroll
      for (int k = 0; k < kCap; ++k) score[k] = (valid[k] && movable) ? depth[k] : kBigNeg;
      const size_t n_em = (size_t)d.nb * d.n_pair_e;
      float* em = sc.em + (size_t)b * d.n_pair_e + lane;
      for (int pick = 0; pick < d.kk; ++pick) {
        float best;
        int bidx;
        argmax(score, best, bidx);
        word |= (unsigned)bidx << (8 + 3 * pick);
        if (best > 0.f) {
          word |= 1u << pick;
          const V3 pt = select(bidx, pts);
          const size_t e = (size_t)pick * d.sat_cap;
          em[e] = pt.x;
          em[n_em + e] = pt.y;
          em[2 * n_em + e] = pt.z;
          em[3 * n_em + e] = best;
        }
#pragma unroll
        for (int k = 0; k < kCap; ++k) score[k] = bidx == k ? kBigNeg : score[k];
      }
      if (word & 0xffu) {
        const size_t lanes = (size_t)d.nb * d.sat_cap;
        sc.lane_n[li] = nrm.x;
        sc.lane_n[lanes + li] = nrm.y;
        sc.lane_n[2 * lanes + li] = nrm.z;
      }
    }
    sc.lane_word[li] = word;
    for (int pick = 0; pick < d.kk; ++pick) {
      const unsigned m = __ballot_sync(0xffffffffu, (word >> pick) & 1u);
      if (wl == 0) gm[pick * (d.sat_cap / 32) + lane / 32] = m;
    }
  } else {
    // ground corners of the bucket's own ranks
    const int r = threadIdx.x;
    const Box gl = load_box(geom, d.npad, start + r);
    const bool mv = gl.movable > 0.f;
    float gsc[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float dep = d.gh - box_corner(gl, c).y;
      gsc[c] = (mv && (dep > 0.f)) ? dep : kBigNeg;
    }
    for (int pick = 0; pick < d.kg; ++pick) {
      float best;
      int bidx;
      argmax(gsc, best, bidx);
      word |= ((unsigned)bidx << (8 + 3 * pick)) | ((best > 0.f ? 1u : 0u) << pick);
#pragma unroll
      for (int c = 0; c < 8; ++c) gsc[c] = bidx == c ? kBigNeg : gsc[c];
    }
    sc.gnd_word[(size_t)b * kBlock + r] = word;
    const int g0 = d.n_pair_e / 32;
    for (int pick = 0; pick < d.kg; ++pick) {
      const unsigned m = __ballot_sync(0xffffffffu, (word >> pick) & 1u);
      if (wl == 0) gm[g0 + pick * (kBlock / 32) + r / 32] = m;
    }
  }
}

// ---------------------------------------------------------------------------
// 3. the slot scan (a block per bucket), the meta counters, the previous keys
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kScanThreads)
box_table_scan_kernel(const int* __restrict__ gate, const float* __restrict__ pcols, Scratch sc,
                      float* __restrict__ meta, Dims d) {
  __shared__ int warp_sums[32];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int ccap = d.ccap;
  if (pcols != nullptr)
    compact_prev_keys(pcols + (size_t)b * ccap * 8, sc.prev + (size_t)b * ccap, sc.n_prev + b, ccap);
  float* mb = meta + (size_t)b * kBlock;
  const size_t mrow = (size_t)d.nb * kBlock;
  if (passed_through(gate, b)) {  // zero meta; every slot of the copy is live
    for (int i = tid; i < 8 * kBlock; i += blockDim.x) mb[(i / kBlock) * mrow + i % kBlock] = 0.f;
    if (tid == 0) sc.nact[b] = ccap;
    return;
  }
  // each active emission's slot, in the reference's order
  const unsigned* gm = sc.group + (size_t)b * d.groups;
  int* slot_em = sc.slot_em + (size_t)b * ccap;
  int n_act = 0;
  for (int g0 = 0; g0 < d.groups; g0 += blockDim.x) {
    const int g = g0 + tid;
    unsigned m = g < d.groups ? gm[g] : 0u;
    int total;
    int s = n_act + block_exclusive_scan(__popc(m), warp_sums, total);
    for (; m && s < ccap; ++s, m &= m - 1) slot_em[s] = 32 * g + __ffs(m) - 1;
    n_act += total;
  }
  // meta: dropped, active, lane drops, window-edge ranks
  for (int i = tid; i < 8 * kBlock; i += blockDim.x) {
    const int r = i / kBlock, c = i % kBlock;
    float val = 0.f;
    if (r == 0 && c == 0) val = (float)(n_act > ccap ? n_act - ccap : 0);
    if (r == 0 && c == 1) val = (float)n_act;
    if (r == 0 && c == 2) val = (float)sc.info[b];
    if (r == 0 && c == 3) val = (float)sc.info[d.nb + b];
    mb[r * mrow + c] = val;
  }
  if (tid == 0) sc.nact[b] = n_act;
}

// ---------------------------------------------------------------------------
// 4. a thread per slot: its table rows and warm key, or the persisted copy
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kRowThreads)
box_table_rows_kernel(const float* __restrict__ geom_all, const int* __restrict__ gate,
                      const float* __restrict__ prev_table, Scratch sc, float* __restrict__ table, Dims d) {
  const float* geom = geom_all + (size_t)kGeomRow0 * d.npad;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int ccap = d.ccap;
  const int j0 = blockIdx.x * kRowThreads;
  const int j = j0 + tid;
  const int start = (d.bucket0 + b) * kBlock;
  const size_t cp = (size_t)d.nb * ccap;
  float* out = table + (size_t)b * ccap;
  float* ck = sc.keys + (size_t)b * ccap;
  float* ch = ck + cp;

  if (passed_through(gate, b)) {
    // the block's slots of the persisted block, a warp a row in 16-byte
    // vectors, and their keys
    const float* src = prev_table + (size_t)b * ccap;
    constexpr int q = kRowThreads / 4;       // vectors a row
    constexpr int per = 32 * q / kRowThreads;  // a thread's vectors of 32 rows
    float4 buf[per];
#pragma unroll
    for (int u = 0; u < per; ++u) {
      const int i = tid + u * kRowThreads;
      if (i < d.rows * q)
        buf[u] = __ldg(reinterpret_cast<const float4*>(src + (size_t)(i / q) * cp + j0 + 4 * (i % q)));
    }
#pragma unroll
    for (int u = 0; u < per; ++u) {
      const int i = tid + u * kRowThreads;
      if (i < d.rows * q) *reinterpret_cast<float4*>(out + (size_t)(i / q) * cp + j0 + 4 * (i % q)) = buf[u];
    }
    ck[j] = warm_key(src[9 * cp + j], src[10 * cp + j], src[12 * cp + j], src[15 * cp + j]);
    ch[j] = src[11 * cp + j];
    return;
  }
  const int n_act = sc.nact[b];
  if (j >= (n_act < ccap ? n_act : ccap)) {
    for (int k = 0; k < d.rows; ++k) out[(size_t)k * cp + j] = 0.f;
    return;
  }
  const int e = sc.slot_em[(size_t)b * ccap + j];
  float v[32];
  V3 pt, a_loc, b_loc, n_loc;
  v[9] = 1.f;
  if (e < d.n_pair_e) {
    const size_t lanes = (size_t)d.nb * d.sat_cap;
    const size_t n_em = (size_t)d.nb * d.n_pair_e;
    const int pick = e / d.sat_cap;
    const size_t li = (size_t)b * d.sat_cap + e % d.sat_cap;
    const int ks = (sc.lane_word[li] >> (8 + 3 * pick)) & 7;
    const int la = sc.lanes[li];
    const int lb = sc.lanes[lanes + li];
    const Box ga = load_box(geom, d.npad, start + la);
    const Box gb = lb >= 0 ? load_box(geom, d.npad, start + lb) : zero_box();
    const V3 n = mk(sc.lane_n[li], sc.lane_n[lanes + li], sc.lane_n[2 * lanes + li]);
    const float* em = sc.em + (size_t)b * d.n_pair_e + e;
    pt = mk(em[0], em[n_em], em[2 * n_em]);
    v[3] = n.x;
    v[4] = n.y;
    v[5] = n.z;
    v[6] = em[3 * n_em];
    v[7] = sqrtf(ga.fric * gb.fric);
    v[8] = fmaxf(ga.rest, gb.rest);
    const int ia = (int)ga.id, ib = (int)gb.id;
    v[10] = (float)(ia > ib ? ia : ib);
    v[11] = (float)(ia < ib ? ia : ib);
    v[12] = 0.f;
    v[13] = (float)(start + la);
    v[14] = (float)(start + lb + 1);
    v[15] = (float)ks;
    a_loc = t_apply(ga.r, sub(pt, ga.p));
    b_loc = t_apply(gb.r, sub(pt, gb.p));
    n_loc = t_apply(ga.r, n);
  } else {
    const int ge = e - d.n_pair_e;
    const int pick = ge / kBlock, r = ge % kBlock;
    const int ks = (sc.gnd_word[(size_t)b * kBlock + r] >> (8 + 3 * pick)) & 7;
    const Box gl = load_box(geom, d.npad, start + r);
    pt = box_corner(gl, ks);
    v[3] = 0.f;
    v[4] = 1.f;
    v[5] = 0.f;
    v[6] = d.gh - pt.y;
    v[7] = gl.fric;
    v[8] = gl.rest;
    v[10] = gl.id;
    v[11] = 0.f;
    v[12] = 1.f;
    v[13] = (float)(start + r);
    v[14] = 0.f;
    v[15] = (float)ks;
    a_loc = t_apply(gl.r, sub(pt, gl.p));
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
#pragma unroll
  for (int k = 0; k < 32; ++k)
    if (k < d.rows) out[(size_t)k * cp + j] = v[k];
  ck[j] = warm_key(v[9], v[10], v[12], v[15]);
  ch[j] = v[11];
}

// Dims of a call, from the C entry points' sizes.
Dims make_dims(int nb, int bucket0, int cap, int cap2, int ccap, int kk, int kg, int npad, int rows, int bp_k,
               int env_k, float gh) {
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
  d.bp_k = bp_k;
  d.env_k = env_k;
  d.n_pair_e = kk * d.sat_cap;
  d.groups = (d.n_pair_e + kg * kBlock) / 32;
  d.gh = gh;
  return d;
}

}  // namespace

// Words (4 bytes) of int32 scratch a table call needs: nb buckets, cap and
// cap2 lanes, kk, kg, ccap.
extern "C" int ct_scratch_words(int nb, int cap, int cap2, int kk, int kg, int ccap) {
  const size_t w = carve_scratch(nullptr, make_dims(nb, 0, cap, cap2, ccap, kk, kg, 0, 0, 0, 0, 0.f)).words;
  return w > 0x7fffffff ? -1 : (int)w;
}

// la/lb NULL with bp_k > 0 (the in-kernel broad phase); gate and prev_table
// NULL unless gated; pcols and warm NULL without warm start.
extern "C" int ct_bucket_contact_table(const float* geom, const int* la, const int* lb, const float* pcols,
                                       const int* gate, const float* prev_table, float* table, float* meta,
                                       float* warm, int* scratch, int scratch_words, int nb, int bucket0, int cap,
                                       int cap2, int ccap, int kk, int kg, int npad, int rows, int bp_k, int env_k,
                                       float gh, void* stream) {
  if (kk > kCap || kg > 8 || rows > 32 || rows < 16 || (cap2 && cap2 > cap) || cap % kPairThreads ||
      cap2 % kPairThreads || ccap % kRowThreads || bucket0 < 0 || bp_k < 0 || bp_k > kBlock ||
      (!bp_k && (la == nullptr || lb == nullptr)) || (env_k && !bp_k) ||
      ((gate == nullptr) != (prev_table == nullptr)) || (((uintptr_t)prev_table | (uintptr_t)table) & 15) ||
      (size_t)(bucket0 + nb + 2) * kBlock > (size_t)npad)
    return (int)cudaErrorInvalidValue;
  const Dims d = make_dims(nb, bucket0, cap, cap2, ccap, kk, kg, npad, rows, bp_k, env_k, gh);
  const Scratch sc = carve_scratch(scratch, d);
  if (sc.words > (size_t)scratch_words) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;

  box_table_lanes_kernel<<<nb, kLaneThreads, 0, st>>>(geom, la, lb, gate, sc, d);
  const int lane_blocks = kk ? d.sat_cap / kPairThreads : 0;
  const int pair_blocks = lane_blocks + (kg > 0 ? 1 : 0);
  if (pair_blocks) box_table_pairs_kernel<<<dim3(pair_blocks, nb), kPairThreads, 0, st>>>(geom, gate, sc, d);
  box_table_scan_kernel<<<nb, kScanThreads, 0, st>>>(gate, pcols, sc, meta, d);
  box_table_rows_kernel<<<dim3(ccap / kRowThreads, nb), kRowThreads, 0, st>>>(geom, gate, prev_table, sc, table, d);
  if (pcols != nullptr) {
    const cudaError_t err =
        launch_warm_match<box_table_warm>(pcols, sc.prev, sc.n_prev, sc.keys, sc.nact, warm, nb, ccap, st);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

// Text of a cudaError_t returned by any entry point of the library.
extern "C" const char* pk_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }
