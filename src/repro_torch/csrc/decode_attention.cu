// Flash-decode for Hopper (sm_90a), CUDA C++: one query token per batch row
// against a long KV cache, in one launch.
//
// Replaces src/repro/kernels/decode_attention.py::_decode_kernel
// (decode_attention.py:26, pallas_call at decode_attention.py:75).
//
// What it computes.  q [B, H, D], k/v [B, S, Hkv, D], lengths [B] int32 ->
// out [B, H, D]: per batch row b and q head h, softmax(q k^T / sqrt(D)) v over
// the keys [0, lengths[b]), where q head h reads kv head h / rep (rep = H /
// Hkv, GQA).  As in the reference, the rep query heads that share a kv head
// form one [rep, D] group, and the softmax is the reference's online softmax
// in f32 over tiles of keys: per tile, scores in f32 times 1/sqrt(D),
// m_new = max(m, rowmax s), p = exp(s - m_new), alpha = exp(m - m_new),
// l = l * alpha + rowsum p (f32 p), acc = acc * alpha + p @ v with p rounded
// to v's dtype and an f32 product; out = acc / max(l, 1e-30), rounded once.
// The running state is a warp's, over its keys of each tile (8 of 64 on
// the tensor-core path, 4 of 32 on the FMA path), where the reference's is a
// 256-key block's.
//
// Grid.  One thread-block cluster per (batch row, kv head, group of at most
// 16 of the kv head's q heads: one group for rep <= 16, three for
// granite-20b's 48 : 1, each reading the kv head's keys); its blocks are
// the splits of the cache, at most kMaxSplits = 16, and their count comes
// from S alone (num_splits), never from the live length, so a decode step's
// launch shape does not depend on its position: a captured CUDA graph replays
// it with the lengths changed in place.  Split s owns the keys [s * span,
// (s + 1) * span) and reads only the live ones, below lengths[b]; a split
// that starts past it reads nothing.  Each block merges its warps' (m, l,
// acc) in warp order into its own shared memory; after cluster.sync() rank 0
// reads the live splits' partials through distributed shared memory in rank
// order and merges them with the reference's formulas, M = max m_s,
// L = sum l_s exp(m_s - M), O = sum acc_s exp(m_s - M), out = O / max(L,
// 1e-30).  No scratch in device memory, no second launch, no atomics and a
// fixed order: a row's bits depend only on its own q, K, V, length and on S,
// never on B or on scheduling.
//
// Each block.  Eight warps.  Thread 0 brings the first kStages tiles'
// K rows and V rows into a ring in shared memory by TMA
// (cp.async.bulk.tensor, one load each for K and V per tile, completing on
// the stage's mbarrier; the tensor maps see the cache's [B, S, Hkv, D]
// layout through its strides); after that the last warp to release a stage
// (empty mbarrier, elected by a count in shared memory) refills it at once.
// No byte passes through registers.  Two paths compute a tile:
//   - bf16 (decode_mma): the products on the tensor cores.  A warp takes
//     8 keys of each 64-key tile; S [16 x 8] = Q K^T is mma.sync m16n8k16
//     over D (Q's rows past the group's are zero and its A fragments stay in
//     registers; K's B fragments by ldmatrix from tiles that TMA wrote with
//     the widest swizzle a row fills, so the ldmatrix rows hit distinct
//     banks); the softmax runs on the accumulator (a row's 8 scores sit in
//     a quad); p, rounded to bf16, is at once the A fragment of O += P V,
//     mma.sync m16n8k8 with V's B fragments by ldmatrix.trans.  bf16
//     products are exact in f32 and the sums are f32.  With at most 8 rows
//     the tile's rows 8..15 are zeros and skipped.  V rows past the length are
//     zeroed in shared memory first (p = 0 must not meet a NaN there).
//   - f32 (decode_fma): FMA on the CUDA
//     cores (the tensor cores have no f32 product without TF32 rounding).  A
//     warp takes 4 keys of each 32-key tile, eight lanes per key: a lane
//     holds D / 8 of the key's elements and its share of the q rows in
//     registers, the partial dot products meet by three shuffles, max and
//     sum over the warp's keys by two, for every row at once; PV: a lane
//     owns D / 32 neighbouring columns of every row, keys in order.
// Why so (measured with tools/decode_ab.py): one load per tile, not one bulk
// copy per 256-byte row, or the copy engine's time per request sets the
// kernel's time; no ninth (producer) warp, which would cut two blocks per SM
// to 96 registers a thread; two blocks per SM (at most 128 registers and
// 113 KB), since with one the 13-16-block clusters wait for room (so the
// tensor-core path keeps two 64-key stages, 32 KB each, in flight: a third
// made it slower); and rank 0 reads each peer's m and l once per row, not
// once per element.
// Head dims.  D = 112 (zamba2-7b) is carried as 128 columns in shared memory:
// its tensor maps have D 112 and the boxes reach 128, so TMA writes zeros
// past 112 (they add nothing to q k^T; their output columns are not stored);
// 112 = 7 x 16 would fit the products, but its rows fill no swizzle span.
// D = 192 (nemotron-4-340b) is three 64-column boxes, its O 96 registers a
// thread: one block per SM.
//
// Layout.  K and V are read in place through their strides in the cache's
// [B, S, Hkv, D] layout: no transpose copy (the reference builds [B*Hkv, S,
// D] copies of both, decode_attention.py:69-70), and only the live prefix is
// read.  The TPU kernel's S % block_k precondition is a Mosaic tiling rule
// and does not carry over: any S works.
//
// Bound on this card.  The work is 4 * D flops per (q head, live key) against
// the live K and V bytes (plus q and out) read or written once:
//   max(B * H * len * 4 * D / 989e12,  (2 * B * len * Hkv * D * el) / 3.35e12)
// (an H100 SXM's published rates at its 700 W limit).  At llama3.2-3b
// widths (H 24, Hkv 8, D 128, bf16) the bytes bound it by far
// (3 flops per byte against the 295 where the tensor cores would take over):
// length 543 is 2.2 MB, 0.66 us; 4096 keys at 32 / 8 heads are 16.8 MB,
// 5.0 us.  A short prefix is bound by latency: one launch, one round trip to
// memory per stage, two cluster barriers.  What the design does about it:
// one launch; up to 16 splits spread a long prefix over 104-128 SMs (8 kv
// heads) with the ring in flight in each; the copies cost the warps no
// instructions; the products run on the tensor cores; every intermediate
// stays on chip.  A block reads at most one partial tile past the live
// length.
//
// C interface (bound with ctypes): every pointer is a device pointer, the
// stream is the caller's current stream, nothing is allocated here, and the
// entry point returns the launch's cudaError_t (0 = launched).

#include <cmath>
#include <cstdint>

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

namespace cg = cooperative_groups;
using hopper::mbar_arrive;
using hopper::mbar_expect_tx;
using hopper::mbar_init;
using hopper::mbar_wait;
using hopper::smem_addr;
using hopper::tma_load_4d;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRingBytes = 64 * 1024;          // the ring's shared memory
constexpr int kMaxStages = 8;                  // tiles in flight per block
constexpr int kMaxSplits = 16;                 // blocks per cluster
constexpr int kSpanUnit = 64;                  // a split's keys: a multiple
constexpr int kMaxRep = 48;                    // q heads per kv head
constexpr int kMmaRows = 16;                   // the products' m (q rows)
// q rows per cluster: a kv head with more q heads (rep > 16) is split into
// groups of 16, a cluster each (granite-20b's 48 : 1 is three)
constexpr int kGroupRows = kMmaRows;

// The head dim a kernel computes with: D = 112 is kept as 128 columns in
// shared memory, where TMA writes zeros past the tensor maps' 112 (they add
// nothing to q k^T, and give output columns that are not stored).
__host__ __device__ constexpr int padded_dim(int D) {
  return D == 112 ? 128 : D;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

struct Strides {
  long long qb, qh, kb, ks, kh, vb, vs, vh;
};

// Keys per split (a multiple of kSpanUnit) for a cache of S keys, and the
// number of splits: at least kSpanUnit keys each, at most kMaxSplits.
__host__ __device__ __forceinline__ int split_keys(int S) {
  int n = (S + kSpanUnit - 1) / kSpanUnit;
  n = n < 1 ? 1 : (n > kMaxSplits ? kMaxSplits : n);
  const int per = (S + n - 1) / n;
  return (per + kSpanUnit - 1) / kSpanUnit * kSpanUnit;
}
__host__ __device__ __forceinline__ int num_splits(int S) {
  const int span = split_keys(S);
  return (S + span - 1) / span;
}

__device__ __forceinline__ int live_length(const int* lengths, int b, int S) {
  return min(max(lengths[b], 0), S);
}

constexpr int stages_for(int tile_bytes) {
  return kRingBytes / tile_bytes < 2
             ? 2
             : (kRingBytes / tile_bytes > kMaxStages ? kMaxStages
                                                     : kRingBytes / tile_bytes);
}

// Dynamic shared memory of a block (bytes from its kAlign-aligned start):
// the full and empty mbarriers of the ring, q [kQRows, D] in f32 (rows past
// rep are zero), the block's merged partials (m [rep], l [rep], acc [rep,
// D], f32, read by rank 0 of the cluster), then the ring of kStages tiles,
// which after the key loop holds the warps' partials for the block's merge.
template <int kQRows, int D, int kTileBytes, int kAlign>
struct Layout {
  static constexpr int kStages = stages_for(kTileBytes);
  static constexpr int kQ = 16 * kStages;
  static constexpr int kPart = kQ + kQRows * D * 4;
  static constexpr int kRing =
      (kPart + kQRows * (D + 2) * 4 + kAlign - 1) / kAlign * kAlign;
  static constexpr int kMerge = kWarps * kQRows * (D + 3) * 4;
  static constexpr int kBytes =
      kAlign + kRing + (kMerge > kStages * kTileBytes ? kMerge
                                                      : kStages * kTileBytes);
};

// What both kernels share: the block's start (barriers, the first tiles'
// loads, q into shared memory) and its end (the warps' partials merged in
// warp order, then rank 0's merge of the cluster's live splits in rank
// order).
struct Block {
  uint32_t base;            // shared memory, aligned
  unsigned char* smem;
  uint32_t* released;       // per stage: warps done with it, ever
  // rep: the q rows of this block's group (at most kGroupRows); row0: the
  // group's first q head
  int kStages, split, b, kvh, len, span, begin, end, ntiles, rep, row0;

  __device__ __forceinline__ uint32_t full(int s) const { return base + 8 * s; }
  __device__ __forceinline__ uint32_t empty(int s) const {
    return base + 8 * (kStages + s);
  }
};

template <typename T, int D>
__device__ __forceinline__ void merge_and_store(cg::cluster_group& cluster,
                                                const Block& blk, float* ring,
                                                float* pm, T* out) {
  constexpr int Dp = padded_dim(D);
  const int rep = blk.rep;
  float* pl = pm + rep;
  float* pacc = pl + rep;
  const float* wacc = ring;                      // [kWarps][rep][Dp]
  const float* wm = wacc + kWarps * rep * Dp;     // [kWarps][rep]
  const float* wl = wm + kWarps * rep;
  // the warps' weights e^(m_w - M) per row (0 for a warp that saw no key),
  // then every element of the block's acc, in warp order
  float* wt = ring + kWarps * rep * (Dp + 2);     // [kWarps][rep]
  __syncthreads();
  for (int r = threadIdx.x; r < rep; r += kThreads) {
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, wm[w * rep + r]);
    float Lsum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float mw = wm[w * rep + r];
      const float e = mw > -INFINITY ? expf(mw - M) : 0.f;
      wt[w * rep + r] = e;
      Lsum = fmaf(wl[w * rep + r], e, Lsum);
    }
    pm[r] = M;
    pl[r] = Lsum;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < rep * Dp; i += kThreads) {
    const int r = i / Dp;
    float O = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      O = fmaf(wacc[(w * rep + r) * Dp + i - r * Dp], wt[w * rep + r], O);
    pacc[i] = O;
  }

  // rank 0 merges the live splits' partials, in rank order: first each
  // row's weights e^(m_s - M) and sum L from the peers' m and l (one read
  // each), then every element of O from the peers' acc
  cluster.sync();
  if (blk.split == 0) {
    const int nlive = (blk.len + blk.span - 1) / blk.span;
    float* weight = ring;                        // [kMaxSplits][rep], free
    float* lsum = weight + kMaxSplits * rep;     // [rep]
    for (int r = threadIdx.x; r < rep; r += kThreads) {
      float ms[kMaxSplits], ls[kMaxSplits];
#pragma unroll
      for (int s = 0; s < kMaxSplits; ++s) {     // the loads fly together
        const int from = s < nlive ? s : 0;
        ms[s] = cluster.map_shared_rank(pm, from)[r];
        ls[s] = cluster.map_shared_rank(pl, from)[r];
      }
      float M = -INFINITY;
#pragma unroll
      for (int s = 0; s < kMaxSplits; ++s)
        if (s < nlive) M = fmaxf(M, ms[s]);
      float Lsum = 0.f;
#pragma unroll
      for (int s = 0; s < kMaxSplits; ++s) {
        const float e = s < nlive ? expf(ms[s] - M) : 0.f;
        weight[s * rep + r] = e;
        Lsum = fmaf(ls[s], e, Lsum);
      }
      lsum[r] = Lsum;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < rep * Dp; i += kThreads) {
      const int r = i / Dp;
      const int c = i - r * Dp;
      if (Dp != D && c >= D) continue;           // a padding column
      float os[kMaxSplits];
#pragma unroll
      for (int s = 0; s < kMaxSplits; ++s)
        os[s] = cluster.map_shared_rank(pacc, s < nlive ? s : 0)[i];
      float O = 0.f;
#pragma unroll
      for (int s = 0; s < kMaxSplits; ++s)
        if (s < nlive) O = fmaf(os[s], weight[s * rep + r], O);
      out[r * D + c] = from_f<T>(nlive ? O / fmaxf(lsum[r], 1e-30f) : 0.f);
    }
  }
  cluster.sync();                                // peers' partials stay
}

// Tile t is done with by this warp: its stage is released, and the last
// warp to release it refills it with tile t + kStages at once.
template <typename Load>
__device__ __forceinline__ void release(const Block& blk, int t,
                                        const Load& load) {
  const int s = t % blk.kStages;
  __syncwarp();
  if ((threadIdx.x & 31) == 0) {
    mbar_arrive(blk.empty(s));
    if (t + blk.kStages < blk.ntiles &&
        atomicAdd(&blk.released[s], 1u) % kWarps == kWarps - 1) {
      mbar_wait(blk.empty(s), (t / blk.kStages) & 1);
      load(blk, t + blk.kStages);
    }
  }
  __syncwarp();
}

// The block's place in the cluster and the cache, its barriers, and the
// first kStages tiles' loads (thread 0); q rows into shared memory.
template <typename T, int D, int kQRows, int kAlign, typename Load>
__device__ __forceinline__ Block start_block(const T* q, const int* lengths,
                                             int S, int Hkv, int rep,
                                             int groups,
                                             long long q_sb, long long q_sh,
                                             int kStages,
                                             unsigned char* smem_raw,
                                             const Load& load, int tile) {
  Block blk;
  cg::cluster_group cluster = cg::this_cluster();
  const uint32_t raw = smem_addr(smem_raw);
  blk.base = (raw + kAlign - 1) & ~uint32_t(kAlign - 1);
  blk.smem = smem_raw + (blk.base - raw);
  blk.kStages = kStages;
  blk.split = static_cast<int>(cluster.block_rank());
  blk.b = blockIdx.x / (Hkv * groups);
  const int hg = blockIdx.x - blk.b * Hkv * groups;
  blk.kvh = hg / groups;
  const int grp = hg - blk.kvh * groups;
  blk.row0 = blk.kvh * rep + grp * kGroupRows;
  blk.len = live_length(lengths, blk.b, S);
  blk.span = split_keys(S);
  blk.begin = blk.split * blk.span;
  blk.end = min(blk.len, blk.begin + blk.span);
  blk.ntiles = blk.end > blk.begin ? (blk.end - blk.begin + tile - 1) / tile : 0;
  blk.rep = min(kGroupRows, rep - grp * kGroupRows);
  __shared__ uint32_t released[kMaxStages];
  blk.released = released;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(blk.full(s), 1);
      mbar_init(blk.empty(s), kWarps);
      released[s] = 0;
    }
    hopper::mbar_init_fence();
    for (int t = 0; t < min(blk.ntiles, kStages); ++t) load(blk, t);
  }
  // q rows [kQRows, Dp] in f32, zero past the group's rows and past D
  constexpr int Dp = padded_dim(D);
  float* qs = reinterpret_cast<float*>(blk.smem + 16 * kStages);
  for (int i = threadIdx.x; i < kQRows * Dp; i += kThreads) {
    const int r = i / Dp;
    const int c = i - r * Dp;
    qs[i] = r < blk.rep && c < D
                ? to_f(q[blk.b * q_sb + (blk.row0 + r) * q_sh + c])
                : 0.f;
  }
  __syncthreads();                               // barriers and q ready
  return blk;
}

// ---------------------------------------------------------------------------
// f32, or more than 16 q rows per kv head: FMA on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kLanesPerKey = 8;
constexpr int kKeysPerWarp = 32 / kLanesPerKey;
constexpr int kTile = kWarps * kKeysPerWarp;   // keys per tile
static_assert(kSpanUnit % kTile == 0, "a split is whole tiles");

template <int D, int kRep>
using FmaLayout = Layout<kRep, padded_dim(D), 2 * kTile * padded_dim(D) * 4,
                         128>;

// kN floats of a K row at p (aligned to their size, at most 16 bytes).
template <int kN>
__device__ __forceinline__ void load_row(const float* p, float* f) {
  if constexpr (kN == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    f[0] = v.x;
    f[1] = v.y;
    f[2] = v.z;
    f[3] = v.w;
  } else if constexpr (kN == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    f[0] = v.x;
    f[1] = v.y;
  } else {
    f[0] = *p;
  }
}

// kRep: the rows a thread keeps registers for (a group's rows <= kRep).
template <int D, int kRep>
__global__ void __launch_bounds__(kThreads, kRep <= 4 && D <= 128 ? 2 : 1)
decode_fma(const __grid_constant__ CUtensorMap tm_k,
           const __grid_constant__ CUtensorMap tm_v,
           const float* __restrict__ q, const int* __restrict__ lengths,
           float* __restrict__ out, int S, int Hkv, int rep, int groups,
           long long q_sb, long long q_sh, float scale) {
  using T = float;
  constexpr int Dp = padded_dim(D);
  using L = FmaLayout<D, kRep>;
  constexpr int kRowBytes = Dp * 4;
  constexpr int kE = Dp / kLanesPerKey;          // a lane's share of a key
  constexpr int kLE = kE < 4 ? kE : 4;           // floats per load
  constexpr int kLoads = kE / kLE;
  constexpr int kCols = Dp >= 32 ? Dp / 32 : 1;  // PV columns per lane
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // one TMA load each for a tile's K and V rows (rows past S arrive as
  // zeros; rows past the length are read but never used)
  const auto load = [&](const Block& blk, int t) {
    const int s = t % L::kStages;
    const uint32_t dst = blk.base + L::kRing + s * (2 * kTile * kRowBytes);
    mbar_expect_tx(blk.full(s), 2 * kTile * kRowBytes);
    tma_load_4d(dst, &tm_k, blk.full(s), 0, blk.kvh, blk.begin + t * kTile,
                blk.b);
    tma_load_4d(dst + kTile * kRowBytes, &tm_v, blk.full(s), 0, blk.kvh,
                blk.begin + t * kTile, blk.b);
  };
  if (threadIdx.x == 0) {                        // ahead of the first loads
    hopper::prefetch_tensor_map(&tm_k);
    hopper::prefetch_tensor_map(&tm_v);
  }
  const Block blk = start_block<T, D, kRep, 128>(
      q, lengths, S, Hkv, rep, groups, q_sb, q_sh, L::kStages, smem_raw,
      load, kTile);
  const int rows = blk.rep;
  const float* qs = reinterpret_cast<const float*>(blk.smem + L::kQ);
  unsigned char* ring = blk.smem + L::kRing;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const bool col_lane = lane * kCols < Dp;       // lane owns PV columns

  float m[kRep], l[kRep], acc[kRep][kCols];
#pragma unroll
  for (int r = 0; r < kRep; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;
  }
  const int kk = lane / kLanesPerKey;            // the lane's key of 4
  const int seg = lane % kLanesPerKey;
  const int key0 = warp * kKeysPerWarp;          // the warp's keys in a tile
  // the lane's share of every q row stays in registers for the whole loop
  float qv[kRep][kE];
#pragma unroll
  for (int r = 0; r < kRep; ++r)
#pragma unroll
    for (int i = 0; i < kLoads; ++i)
#pragma unroll
      for (int j = 0; j < kLE; ++j)
        qv[r][i * kLE + j] = qs[r * Dp + (i * kLanesPerKey + seg) * kLE + j];

  for (int t = 0; t < blk.ntiles; ++t) {
    const int s = t % L::kStages;
    mbar_wait(blk.full(s), (t / L::kStages) & 1);
    const T* kt =
        reinterpret_cast<const T*>(ring + s * (2 * kTile * kRowBytes));
    const T* vt = kt + kTile * Dp;
    const int nvalid =
        min(kKeysPerWarp, blk.end - (blk.begin + t * kTile + key0));
    if (nvalid > 0) {                            // uniform across the warp
      float kf[kE];
      const T* krow = kt + (key0 + kk) * Dp;
#pragma unroll
      for (int i = 0; i < kLoads; ++i)
        load_row<kLE>(krow + (i * kLanesPerKey + seg) * kLE, kf + i * kLE);
      const bool valid = kk < nvalid;
      // every row at once, so that the rows' shuffles overlap
      float sc[kRep], mt[kRep], p[kRep], al[kRep], ps[kRep];
#pragma unroll
      for (int r = 0; r < kRep; ++r) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < kE; ++e) dot = fmaf(qv[r][e], kf[e], dot);
        sc[r] = dot;
      }
#pragma unroll
      for (int o = 1; o < kLanesPerKey; o <<= 1)
#pragma unroll
        for (int r = 0; r < kRep; ++r)
          sc[r] += __shfl_xor_sync(0xffffffffu, sc[r], o);
#pragma unroll
      for (int r = 0; r < kRep; ++r) {
        sc[r] = valid ? sc[r] * scale : -INFINITY;
        mt[r] = sc[r];
      }
#pragma unroll
      for (int o = kLanesPerKey; o < 32; o <<= 1)
#pragma unroll
        for (int r = 0; r < kRep; ++r)
          mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], o));
#pragma unroll
      for (int r = 0; r < kRep; ++r) {
        const float m_new = fmaxf(m[r], mt[r]);   // finite: a key is valid
        p[r] = valid ? expf(sc[r] - m_new) : 0.f;
        al[r] = expf(m[r] - m_new);
        m[r] = m_new;
        ps[r] = p[r];
      }
#pragma unroll
      for (int o = kLanesPerKey; o < 32; o <<= 1)
#pragma unroll
        for (int r = 0; r < kRep; ++r)
          ps[r] += __shfl_xor_sync(0xffffffffu, ps[r], o);
#pragma unroll
      for (int r = 0; r < kRep; ++r) {
        l[r] = l[r] * al[r] + ps[r];             // v is f32: p stays f32
      }
      // acc = acc * alpha, then + p v key by key, in key order
#pragma unroll
      for (int r = 0; r < kRep; ++r)
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[r][c] *= al[r];
#pragma unroll
      for (int j = 0; j < kKeysPerWarp; ++j) {
        if (j >= nvalid) break;
        float vv[kCols];
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          vv[c] = col_lane ? vt[(key0 + j) * Dp + lane * kCols + c] : 0.f;
#pragma unroll
        for (int r = 0; r < kRep; ++r) {
          const float pj = __shfl_sync(0xffffffffu, p[r], j * kLanesPerKey);
#pragma unroll
          for (int c = 0; c < kCols; ++c) acc[r][c] = fmaf(pj, vv[c], acc[r][c]);
        }
      }
    }
    release(blk, t, load);
  }
  __syncthreads();                               // the ring is free

  float* wacc = reinterpret_cast<float*>(ring);  // [kWarps][rows][Dp]
  float* wm = wacc + kWarps * rows * Dp;         // [kWarps][rows]
  float* wl = wm + kWarps * rows;
#pragma unroll
  for (int r = 0; r < kRep; ++r) {
    if (r >= rows) break;
    if (col_lane) {
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        wacc[(warp * rows + r) * Dp + lane * kCols + c] = acc[r][c];
    }
    if (lane == 0) {
      wm[warp * rows + r] = m[r];
      wl[warp * rows + r] = l[r];
    }
  }
  cg::cluster_group cluster = cg::this_cluster();
  merge_and_store<T, D>(cluster, blk, wacc,
                        reinterpret_cast<float*>(blk.smem + L::kPart),
                        out + (static_cast<size_t>(blk.b) * Hkv * rep +
                               blk.row0) * D);
}

// ---------------------------------------------------------------------------
// bf16, at most 16 q rows per kv head: the products on the tensor cores
// ---------------------------------------------------------------------------
//
// A warp takes 8 keys of each 64-key tile.  S [16 x 8] = Q K^T is mma.sync
// m16n8k16 over D (Q's rows past rep are zero, its A fragments stay in
// registers; K's B fragments by ldmatrix); the online softmax runs on the
// accumulator (a row's 8 scores sit in the 4 lanes of a quad); p, rounded
// to bf16, is at once the A fragment of O [16 x D] += P V, mma.sync m16n8k8
// with V's B fragments by ldmatrix.trans.  bf16 products are exact in f32
// and the sums are f32, as on the FMA path.  K and V tiles arrive by TMA
// with the widest swizzle a row of D (or of 64 of its elements) fills, so
// the ldmatrix rows hit distinct banks.

constexpr int kMmaKeys = 8;                    // keys per warp per tile
constexpr int kMmaTile = kWarps * kMmaKeys;    // keys per tile
static_assert(kSpanUnit % kMmaTile == 0, "a split is whole tiles");

template <int D>
struct MmaTile {
  static constexpr int kChunk = D < 64 ? D : 64;   // elements per row
  static constexpr int kRowBytes = kChunk * 2;     // one swizzle span
  static constexpr int kChunks = D / kChunk;
  static constexpr int kBoxBytes = kMmaTile * kRowBytes;
  static constexpr int kBytes = 2 * kChunks * kBoxBytes;   // K, then V
  static constexpr uint32_t kSwizzle = kRowBytes / 16 - 1;  // 7, 3 or 1
  // byte offset of row r, 16-byte chunk c (of D) in a K or V tile, swizzled
  // as TMA wrote it: bits [4, 7) of the offset XOR bits [7, 10)
  __device__ __forceinline__ static uint32_t at(int r, int c) {
    const uint32_t o = (c / (kChunk / 8)) * kBoxBytes + r * kRowBytes +
                       (c % (kChunk / 8)) * 16;
    return o ^ (((o >> 7) & kSwizzle) << 4);
  }
};
template <int D, int kRows>
using MmaLayout = Layout<kRows, padded_dim(D), MmaTile<padded_dim(D)>::kBytes,
                         1024>;

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(addr));
}

// c[16 x 8] += a[16 x 16] b[16 x 8]; lane t = 4 g + i holds c rows g and
// g + 8, columns 2 i and 2 i + 1.
__device__ __forceinline__ void mma_k16(float (&c)[4], const uint32_t (&a)[4],
                                        uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// c[16 x 8] += a[16 x 8] b[8 x 8]
__device__ __forceinline__ void mma_k8(float (&c)[4], uint32_t a0,
                                       uint32_t a1, uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// kRows: the q rows the products carry, 8 or 16 (a group's rows <= kRows);
// with 8, the m16 tile's rows 8..15 are zeros, and their softmax is not run.
// D = 192 holds O in 96 registers a thread and a 48 KB K/V tile: one block
// per SM.
template <int D, int kRows>
__global__ void __launch_bounds__(kThreads, D <= 128 ? 2 : 1)
decode_mma(const __grid_constant__ CUtensorMap tm_k,
           const __grid_constant__ CUtensorMap tm_v,
           const __nv_bfloat16* __restrict__ q,
           const int* __restrict__ lengths, __nv_bfloat16* __restrict__ out,
           int S, int Hkv, int rep, int groups, long long q_sb, long long q_sh,
           float scale) {
  constexpr int Dp = padded_dim(D);
  using L = MmaLayout<D, kRows>;
  using Tl = MmaTile<Dp>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // K's boxes, then V's: kChunks column boxes of 64 rows each
  const auto load = [&](const Block& blk, int t) {
    const int s = t % L::kStages;
    const uint32_t dst = blk.base + L::kRing + s * Tl::kBytes;
    const int k0 = blk.begin + t * kMmaTile;
    mbar_expect_tx(blk.full(s), Tl::kBytes);
#pragma unroll
    for (int c = 0; c < Tl::kChunks; ++c) {
      tma_load_4d(dst + c * Tl::kBoxBytes, &tm_k, blk.full(s),
                  c * Tl::kChunk, blk.kvh, k0, blk.b);
      tma_load_4d(dst + (Tl::kChunks + c) * Tl::kBoxBytes, &tm_v, blk.full(s),
                  c * Tl::kChunk, blk.kvh, k0, blk.b);
    }
  };
  if (threadIdx.x == 0) {                        // ahead of the first loads
    hopper::prefetch_tensor_map(&tm_k);
    hopper::prefetch_tensor_map(&tm_v);
  }
  const Block blk = start_block<__nv_bfloat16, D, kRows, 1024>(
      q, lengths, S, Hkv, rep, groups, q_sb, q_sh, L::kStages, smem_raw,
      load, kMmaTile);
  const int rows = blk.rep;
  const float* qs = reinterpret_cast<const float*>(blk.smem + L::kQ);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;                       // rows g and g + 8
  const int tq = lane & 3;                       // keys / columns 2 tq, + 1
  const int key0 = warp * kMmaKeys;              // the warp's keys in a tile

  // Q's A fragments (rows past rep are zero), for the whole loop; rows
  // g + 8 only when kRows is 16
  constexpr int kHalves = kRows / 8;
  uint32_t qa[Dp / 16][4];
#pragma unroll
  for (int ks = 0; ks < Dp / 16; ++ks)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = g + 8 * (e & 1);
      const int col = 16 * ks + 8 * (e >> 1) + 2 * tq;
      qa[ks][e] = (e & 1) && kHalves == 1
                      ? 0u
                      : pack_bf16(qs[row * Dp + col], qs[row * Dp + col + 1]);
    }
  float o[Dp / 8][4];
#pragma unroll
  for (int n = 0; n < Dp / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY};
  float l_r[2] = {0.f, 0.f};                     // this lane's part of l

  for (int t = 0; t < blk.ntiles; ++t) {
    const int s = t % L::kStages;
    mbar_wait(blk.full(s), (t / L::kStages) & 1);
    const uint32_t kst = blk.base + L::kRing + s * Tl::kBytes;
    const uint32_t vst = kst + Tl::kChunks * Tl::kBoxBytes;
    const int first = blk.begin + t * kMmaTile + key0;   // the warp's key 0
    const int nvalid = min(kMmaKeys, blk.end - first);
    if (nvalid > 0) {                            // uniform across the warp
      if (nvalid < kMmaKeys) {
        // rows past the length may hold anything (NaN): p = 0 must meet
        // zeros in P V
        for (int i = lane; i < (kMmaKeys - nvalid) * (Dp / 8); i += 32) {
          const int r = key0 + nvalid + i / (Dp / 8);
          const uint32_t a = vst + Tl::at(r, i % (Dp / 8));
          asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};\n" ::"r"(a),
                       "r"(0u)
                       : "memory");
        }
        __syncwarp();
      }
      // S = Q K^T: the warp's 8 keys, D in steps of 16
      float sc[4] = {0.f, 0.f, 0.f, 0.f};
      const int lr = key0 + (lane & 7);          // ldmatrix row of this lane
      if constexpr (Dp == 16) {
        uint32_t kb[2];
        ldsm_x2(kb, kst + Tl::at(lr, (lane >> 3) & 1));
        mma_k16(sc, qa[0], kb[0], kb[1]);
      } else {
#pragma unroll
        for (int p = 0; p < Dp / 32; ++p) {
          uint32_t kb[4];
          ldsm_x4(kb, kst + Tl::at(lr, 4 * p + (lane >> 3)));
          mma_k16(sc, qa[2 * p], kb[0], kb[1]);
          mma_k16(sc, qa[2 * p + 1], kb[2], kb[3]);
        }
      }
      // the online softmax, rows g (r = 0) and g + 8 (r = 1)
      uint32_t pa[2] = {0u, 0u};
#pragma unroll
      for (int r = 0; r < kHalves; ++r) {
        float x0 = first + 2 * tq < blk.end ? sc[2 * r] * scale : -INFINITY;
        float x1 = first + 2 * tq + 1 < blk.end ? sc[2 * r + 1] * scale
                                                 : -INFINITY;
        float mt = fmaxf(x0, x1);
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
        const float m_new = fmaxf(m_r[r], mt);   // finite: a key is valid
        x0 = expf(x0 - m_new);
        x1 = expf(x1 - m_new);
        const float alpha = expf(m_r[r] - m_new);
        l_r[r] = l_r[r] * alpha + (x0 + x1);
        m_r[r] = m_new;
#pragma unroll
        for (int n = 0; n < Dp / 8; ++n) {
          o[n][2 * r] *= alpha;
          o[n][2 * r + 1] *= alpha;
        }
        pa[r] = pack_bf16(x0, x1);               // p rounded to bf16
      }
      // O += P V, 8 columns of D per product
      if constexpr (Dp == 16) {
        uint32_t vb[2];
        ldsm_x2_trans(vb, vst + Tl::at(lr, (lane >> 3) & 1));
        mma_k8(o[0], pa[0], pa[1], vb[0]);
        mma_k8(o[1], pa[0], pa[1], vb[1]);
      } else {
#pragma unroll
        for (int p = 0; p < Dp / 32; ++p) {
          uint32_t vb[4];
          ldsm_x4_trans(vb, vst + Tl::at(lr, 4 * p + (lane >> 3)));
#pragma unroll
          for (int m = 0; m < 4; ++m) mma_k8(o[4 * p + m], pa[0], pa[1], vb[m]);
        }
      }
      if (nvalid < kMmaKeys)                     // the zeros, before TMA
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    }
    release(blk, t, load);
  }
  __syncthreads();                               // the ring is free

  // this warp's (m, l, acc) of the group's rows into the ring
  float* wacc = reinterpret_cast<float*>(blk.smem + L::kRing);
  float* wm = wacc + kWarps * rows * Dp;
  float* wl = wm + kWarps * rows;
#pragma unroll
  for (int r = 0; r < kHalves; ++r) {
    const int row = g + 8 * r;
    float l = l_r[r];                            // the quad's parts of l
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    if (row < rows) {
#pragma unroll
      for (int n = 0; n < Dp / 8; ++n) {
        wacc[(warp * rows + row) * Dp + 8 * n + 2 * tq] = o[n][2 * r];
        wacc[(warp * rows + row) * Dp + 8 * n + 2 * tq + 1] = o[n][2 * r + 1];
      }
      if (tq == 0) {
        wm[warp * rows + row] = m_r[r];
        wl[warp * rows + row] = l;
      }
    }
  }
  cg::cluster_group cluster = cg::this_cluster();
  merge_and_store<__nv_bfloat16, D>(
      cluster, blk, wacc, reinterpret_cast<float*>(blk.smem + L::kPart),
      out + (static_cast<size_t>(blk.b) * Hkv * rep + blk.row0) * D);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// Launches `fn` on a (clusters, splits) grid in clusters of (1, splits),
// after setting, once per kernel and before any capture, its shared memory
// and clusters of more than 8 blocks.
template <auto fn, typename... Args>
int launch_cluster(int smem, int clusters, int S, cudaStream_t stream,
                   Args... args) {
  static const cudaError_t ready = [smem] {
    cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(
          fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    return e;
  }();
  if (ready != cudaSuccess) return static_cast<int>(ready);
  const int nsplit = num_splits(S);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters, nsplit, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = nsplit;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, fn, args...));
}

// One cluster per (batch row, kv head, group of at most kGroupRows q heads):
// bf16 on the tensor cores (8 or 16 rows a product), f32 on FMA (4 or 16
// rows in registers).
template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* lengths,
           void* out, int B, int S, int Hkv, int rep, const Strides& st,
           float scale, cudaStream_t stream) {
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int Dp = padded_dim(D);
  const CUtensorMapDataType dtype = kBf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                          : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const int groups = (rep + kGroupRows - 1) / kGroupRows;
  const int rows = rep < kGroupRows ? rep : kGroupRows;
  // the tensor-core path reads swizzled column boxes of 64 keys, the FMA
  // path plain rows of 32 keys; either reaches past D = 112 to 128 columns
  const int box_d = kBf16 ? MmaTile<Dp>::kChunk : Dp;
  const int box_s = kBf16 ? kMmaTile : kTile;
  const CUtensorMapSwizzle swizzle =
      !kBf16 ? CU_TENSOR_MAP_SWIZZLE_NONE
             : (MmaTile<Dp>::kRowBytes == 128
                    ? CU_TENSOR_MAP_SWIZZLE_128B
                    : (MmaTile<Dp>::kRowBytes == 64
                           ? CU_TENSOR_MAP_SWIZZLE_64B
                           : CU_TENSOR_MAP_SWIZZLE_32B));
  CUtensorMap mk, mv;
  int rc = hopper::tensor_map(&mk, dtype, sizeof(T), k, B, S, Hkv, D, st.kb,
                              st.ks, st.kh, box_d, box_s, swizzle);
  if (rc == 0)
    rc = hopper::tensor_map(&mv, dtype, sizeof(T), v, B, S, Hkv, D, st.vb,
                            st.vs, st.vh, box_d, box_s, swizzle);
  if (rc) return rc;
  const auto* qp = static_cast<const T*>(q);
  const auto* lp = static_cast<const int*>(lengths);
  auto* op = static_cast<T*>(out);
  const int clusters = B * Hkv * groups;
  if constexpr (kBf16) {
    if (rows <= 8)
      return launch_cluster<decode_mma<D, 8>>(
          MmaLayout<D, 8>::kBytes, clusters, S, stream, mk, mv, qp, lp, op, S,
          Hkv, rep, groups, st.qb, st.qh, scale);
    return launch_cluster<decode_mma<D, 16>>(
        MmaLayout<D, 16>::kBytes, clusters, S, stream, mk, mv, qp, lp, op, S,
        Hkv, rep, groups, st.qb, st.qh, scale);
  } else {
    if (rows <= 4)
      return launch_cluster<decode_fma<D, 4>>(
          FmaLayout<D, 4>::kBytes, clusters, S, stream, mk, mv, qp, lp, op, S,
          Hkv, rep, groups, st.qb, st.qh, scale);
    return launch_cluster<decode_fma<D, kGroupRows>>(
        FmaLayout<D, kGroupRows>::kBytes, clusters, S, stream, mk, mv, qp, lp,
        op, S, Hkv, rep, groups, st.qb, st.qh, scale);
  }
}

template <typename T>
int dispatch(int D, const void* q, const void* k, const void* v,
             const void* lengths, void* out, int B, int S, int Hkv, int rep,
             const Strides& st, float scale, cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, lengths, out, B, S, Hkv, rep, st, scale,
                           stream);
    case 32:
      return launch<T, 32>(q, k, v, lengths, out, B, S, Hkv, rep, st, scale,
                           stream);
    case 64:
      return launch<T, 64>(q, k, v, lengths, out, B, S, Hkv, rep, st, scale,
                           stream);
    case 112:
      return launch<T, 112>(q, k, v, lengths, out, B, S, Hkv, rep, st, scale,
                            stream);
    case 128:
      return launch<T, 128>(q, k, v, lengths, out, B, S, Hkv, rep, st, scale,
                            stream);
    case 192:
      return launch<T, 192>(q, k, v, lengths, out, B, S, Hkv, rep, st, scale,
                            stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Splits (blocks per cluster) for a cache of S keys.
extern "C" int decode_attention_splits(int S) {
  return S > 0 ? num_splits(S) : 0;
}

extern "C" int decode_attention_max_rep() { return kMaxRep; }

// dtype: 0 = float32, 1 = bfloat16.  q [B, H, D], k/v [B, S, Hkv, D] through
// strides (qb, qh, kb, ks, kh, vb, vs, vh; unit stride over D, k and v
// 16-byte aligned), lengths [B] int32, out [B, H, D] contiguous.
extern "C" int decode_attention_fwd(int dtype, const void* q, const void* k,
                                    const void* v, const void* lengths,
                                    void* out, int B, int S, int H, int Hkv,
                                    int D, const long long* strides,
                                    float scale, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (Hkv <= 0 || H % Hkv || H / Hkv > kMaxRep)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides st{strides[0], strides[1], strides[2], strides[3],
                   strides[4], strides[5], strides[6], strides[7]};
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(D, q, k, v, lengths, out, B, S, Hkv, H / Hkv, st,
                           scale, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(D, q, k, v, lengths, out, B, S, Hkv,
                                   H / Hkv, st, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* decode_attention_error_string(int code) {
  return hopper::error_string(code);
}
