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
// granite-20b's 48 : 1, five for falcon-7b's 71 : 1, each reading the kv
// head's keys; any rep); its blocks are
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
// Head dims.  Every D >= 1 runs.  A D that is a multiple of 8 from 8 to 256
// with k and v 16-byte aligned (pointers and strides; every served shape) runs
// in the smallest instance width W in {16, 32, 64, 80, 96, 112, 128, 192, 256}
// that holds it.  In the TMA instances the tensor maps have the true D
// columns and the boxes reach W, so TMA writes zeros past D (they add nothing
// to q k^T; their output columns are not stored; no byte past D is read from
// device memory), and the q rows are zero past D in shared memory.  W = 112
// (zamba2-7b) is carried as 128 columns: 112 = 7 x 16 would fit the
// products, but its rows fill no swizzle span.  The tensor-core path reads
// boxes of 64 columns, or of 32 (W 96) or 16 (W 80, whose last 16 columns
// are one k16 product); W = 192 and 256 (nemotron-4-340b, gemma-7b) hold O
// in 96 / 128 registers a thread: one block per SM.  The FMA path gives a
// lane ceil(W / 32) output columns (those past W own nothing).  In bf16
// every other shape runs on the tensor cores too (route_of):
//   - D up to 256 with a row TMA cannot load (D 4, 20, 100: no whole number
//     of 16 bytes) or an unaligned cache: decode_mma<W, kRows, true> at the
//     W that holds D rounded up to 8, its tiles filled by narrow copies
//     (hopper::copy_tile: cp.async of the widest piece the rows, strides
//     and pointer allow, 16, 8 or 4 bytes, or 2-byte loads and st.shared)
//     into the very layout and swizzle TMA writes, zeros past D and past
//     the length; the products, softmax and merge are the TMA instance's,
//     so where both run they give the same bits (tests/test_torch_cuda.py).
//     A warp reads only its own 8 rows of each tile, so it copies those
//     rows itself, for tile t + kStages once it is done with tile t, and
//     waits for its own cp.async groups: no producer warp (the registers,
//     as above) and no barrier between warps, two blocks a SM to D 128.
//   - D past 256, any D: decode_wide (below), 128-column output slices on
//     a grid axis, S rebuilt from 128-column pieces of Q and K in each
//     slice, both streamed through each warp's ring.
// f32 at those shapes runs in the CUDA-core instance of attention_any.cuh
// (one block per batch row, kv head and group of 8 q heads walks the row's
// live keys: no split).  The softmax scale is
// the caller's, 1/sqrt(D) of the true D.  What the A/B runs showed
// (tools/decode_ab.py against the CUDA-core instance bf16 took there before;
// one row, 543 of 576 keys, 32 / 8 heads, device us, NVIDIA H100 80GB HBM3
// at 700 W): D 4 / 20 / 100 at 5.8 / 6.4 / 8.8 (was 47 / 47 / 83; SDPA
// 17.5 / 18.5 / 20.5 in chip_smoke.py), D 264 / 320 / 512 at 25.0 / 24.5 /
// 28.8 (was 140 / 155 / 227; SDPA 93 / 104 / 149); the TMA instances' bits
// and times unchanged.  decode_wide's time steps with its clusters of big
// blocks, not with D (decode_ab.py --heads: 11.8 us at 54 blocks, 25.2 at
// 216, D 264): PERF.md.
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
// heads) with the ring in flight in each; the TMA copies cost the warps no
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

#include "attention_any.cuh"
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
constexpr int kMmaRows = 16;                   // the products' m (q rows)
// q rows per cluster: a kv head with more q heads (rep > 16) is split into
// groups of 16, a cluster each (granite-20b's 48 : 1 is three)
constexpr int kGroupRows = kMmaRows;

// The columns an instance of width W computes with: W = 112 is kept as 128
// columns in shared memory, where TMA writes zeros past the tensor maps'
// true D (they add nothing to q k^T, and give output columns that are not
// stored).
__host__ __device__ constexpr int padded_dim(int W) {
  return W == 112 ? 128 : W;
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

// The piece widths of the narrow copies of q, k and v, in elements
// (hopper::piece_elems).
struct Pieces {
  int q, k, v;
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

// What the kernels share: the block's start (its place, the barriers, the
// first tiles' loads) and its end (the warps' partials merged in warp
// order, then rank 0's merge of the cluster's live splits in rank order).
struct Block {
  uint32_t base;            // shared memory, aligned
  unsigned char* smem;
  uint32_t* released;       // per stage: warps done with it, ever
  // rep: the q rows of this block's group (at most kGroupRows); row0: the
  // group's first q head; dt: the true head dim (the columns of q and out)
  int kStages, split, b, kvh, len, span, begin, end, ntiles, rep, row0, dt;

  __device__ __forceinline__ uint32_t full(int s) const { return base + 8 * s; }
  __device__ __forceinline__ uint32_t empty(int s) const {
    return base + 8 * (kStages + s);
  }
};

// Dp: the columns of the partials; out: row r, column c at out[r * dt + c],
// for the columns c < ncols.
template <typename T, int Dp>
__device__ __forceinline__ void merge_and_store(cg::cluster_group& cluster,
                                                const Block& blk, float* ring,
                                                float* pm, T* out,
                                                int ncols) {
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
      if (c >= ncols) continue;                  // a padding column
      float os[kMaxSplits];
#pragma unroll
      for (int s = 0; s < kMaxSplits; ++s)
        os[s] = cluster.map_shared_rank(pacc, s < nlive ? s : 0)[i];
      float O = 0.f;
#pragma unroll
      for (int s = 0; s < kMaxSplits; ++s)
        if (s < nlive) O = fmaf(os[s], weight[s * rep + r], O);
      out[r * blk.dt + c] =
          from_f<T>(nlive ? O / fmaxf(lsum[r], 1e-30f) : 0.f);
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

// The block's place in the cluster and the cache, its kStages ring
// barriers (thread 0), then first(blk) in every thread: the first tiles'
// loads.
template <int kAlign, typename First>
__device__ __forceinline__ Block start_block(const int* lengths, int S,
                                             int Hkv, int rep, int groups,
                                             int dt, int kStages,
                                             unsigned char* smem_raw,
                                             const First& first, int tile) {
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
  blk.dt = dt;
  __shared__ uint32_t released[kMaxStages];
  blk.released = released;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(blk.full(s), 1);
      mbar_init(blk.empty(s), kWarps);
      released[s] = 0;
    }
    hopper::mbar_init_fence();
  }
  first(blk);
  return blk;
}

// The TMA loads of the first kStages tiles, by thread 0 (after its own
// initialisation of the barriers).
template <typename Load>
__device__ __forceinline__ auto tma_first(const Load& load) {
  return [&load](const Block& blk) {
    if (threadIdx.x == 0)
      for (int t = 0; t < min(blk.ntiles, blk.kStages); ++t) load(blk, t);
  };
}

// The group's q rows into shared memory at qs as [kQRows, Dp] f32, zero
// past the group's rows and past dt.
template <typename T, int Dp, int kQRows>
__device__ __forceinline__ void q_rows_f32(const Block& blk, const T* q,
                                           long long q_sb, long long q_sh,
                                           float* qs) {
  for (int i = threadIdx.x; i < kQRows * Dp; i += kThreads) {
    const int r = i / Dp;
    const int c = i - r * Dp;
    qs[i] = r < blk.rep && c < blk.dt
                ? to_f(q[blk.b * q_sb + (blk.row0 + r) * q_sh + c])
                : 0.f;
  }
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
           int dt, long long q_sb, long long q_sh, float scale) {
  using T = float;
  constexpr int Dp = padded_dim(D);
  using L = FmaLayout<D, kRep>;
  constexpr int kRowBytes = Dp * 4;
  constexpr int kE = Dp / kLanesPerKey;          // a lane's share of a key
  constexpr int kLE = kE % 4 == 0 ? 4 : (kE % 2 == 0 ? 2 : 1);  // per load
  constexpr int kLoads = kE / kLE;
  constexpr int kCols = (Dp + 31) / 32;          // PV columns per lane
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
  const Block blk = start_block<128>(lengths, S, Hkv, rep, groups, dt,
                                     L::kStages, smem_raw, tma_first(load),
                                     kTile);
  float* qs = reinterpret_cast<float*>(blk.smem + L::kQ);
  q_rows_f32<T, Dp, kRep>(blk, q, q_sb, q_sh, qs);
  __syncthreads();                               // barriers and q ready
  const int rows = blk.rep;
  unsigned char* ring = blk.smem + L::kRing;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // column c of the lane's PV columns lies in the row (W 80: lanes own 3)
  const auto col_in = [&](int c) { return lane * kCols + c < Dp; };

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
          vv[c] = col_in(c) ? vt[(key0 + j) * Dp + lane * kCols + c] : 0.f;
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
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      if (col_in(c)) wacc[(warp * rows + r) * Dp + lane * kCols + c] = acc[r][c];
    if (lane == 0) {
      wm[warp * rows + r] = m[r];
      wl[warp * rows + r] = l[r];
    }
  }
  cg::cluster_group cluster = cg::this_cluster();
  merge_and_store<T, Dp>(cluster, blk, wacc,
                         reinterpret_cast<float*>(blk.smem + L::kPart),
                         out + (static_cast<size_t>(blk.b) * Hkv * rep +
                                blk.row0) * dt, dt);
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
  // elements per row of a box: 64, or 32 / 16 where D is no multiple of 64
  static constexpr int kChunk = D % 64 == 0 ? 64 : (D % 32 == 0 ? 32 : 16);
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

// The online softmax of one tile on a warp's scores, S [16 x 8] in the
// m16n8 accumulator sc (rows g and g + 8, the warp's keys first + 2 tq and
// + 1): keys at or past `end` masked, m and l updated, O's kN blocks of 8
// columns rescaled, and p, rounded to bf16, packed into P V's A fragments
// (pa[0] rows g, pa[1] rows g + 8; zero for rows not carried).
template <int kHalves, int kN>
__device__ __forceinline__ void softmax_tile(const float (&sc)[4], int first,
                                             int end, int tq, float scale,
                                             float (&m_r)[2], float (&l_r)[2],
                                             float (&o)[kN][4],
                                             uint32_t (&pa)[2]) {
  pa[0] = pa[1] = 0u;
#pragma unroll
  for (int r = 0; r < kHalves; ++r) {
    float x0 = first + 2 * tq < end ? sc[2 * r] * scale : -INFINITY;
    float x1 = first + 2 * tq + 1 < end ? sc[2 * r + 1] * scale : -INFINITY;
    float mt = fmaxf(x0, x1);
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
    const float m_new = fmaxf(m_r[r], mt);       // finite: a key is valid
    x0 = expf(x0 - m_new);
    x1 = expf(x1 - m_new);
    const float alpha = expf(m_r[r] - m_new);
    l_r[r] = l_r[r] * alpha + (x0 + x1);
    m_r[r] = m_new;
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      o[n][2 * r] *= alpha;
      o[n][2 * r + 1] *= alpha;
    }
    pa[r] = pack_bf16(x0, x1);                   // p rounded to bf16
  }
}

// A warp's (m, l, O) of the group's rows into [kWarps][rows][kCols] at
// wacc, then m and l [kWarps][rows] after it, for merge_and_store.
template <int kHalves, int kN>
__device__ __forceinline__ void store_partials(float* wacc, int rows,
                                               const float (&o)[kN][4],
                                               const float (&m_r)[2],
                                               const float (&l_r)[2]) {
  constexpr int kCols = 8 * kN;
  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2;
  const int tq = threadIdx.x & 3;
  float* wm = wacc + kWarps * rows * kCols;
  float* wl = wm + kWarps * rows;
#pragma unroll
  for (int r = 0; r < kHalves; ++r) {
    const int row = g + 8 * r;
    float l = l_r[r];                            // the quad's parts of l
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    if (row < rows) {
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        wacc[(warp * rows + row) * kCols + 8 * n + 2 * tq] = o[n][2 * r];
        wacc[(warp * rows + row) * kCols + 8 * n + 2 * tq + 1] =
            o[n][2 * r + 1];
      }
      if (tq == 0) {
        wm[warp * rows + row] = m_r[r];
        wl[warp * rows + row] = l;
      }
    }
  }
}

// Narrow copies: rows [first, first + kMmaKeys) of one head of k or v
// (`head`, row stride ss) into a tile of kBoxRows-row boxes of kBox columns
// at dst, as TMA writes it (hopper::copy_tile, by the 32 lanes of the
// calling warp): columns [c0, c0 + kCols) of each row, zero at or past dt,
// and rows at or past `end` zero (p = 0 must meet no NaN in P V).
template <int kBoxRows, int kCols, int kBox>
__device__ __forceinline__ void copy_keys(uint32_t dst,
                                          const __nv_bfloat16* head,
                                          long long ss, int first, int end,
                                          int c0, int dt, int piece) {
  hopper::copy_tile_w<kBoxRows, kCols, kBox>(
      piece, dst, kMmaKeys, dt - c0,
      [&](int r) {
        return first + r < end ? head + (first + r) * ss + c0 : nullptr;
      },
      threadIdx.x & 31, 32);
}

// kRows: the q rows the products carry, 8 or 16 (a group's rows <= kRows);
// with 8, the m16 tile's rows 8..15 are zeros, and their softmax is not run.
// D = 192 holds O in 96 registers a thread and a 48 KB K/V tile: one block
// per SM.  kNarrow: the tiles come by the narrow copies from k and v (the
// tensor maps are then unused): each warp copies the 8 rows of K and of V
// that it alone reads into its rows of the stage, for tile t + kStages as
// soon as it is done with tile t, and waits for its own copies (cp.async
// groups, then __syncwarp): no barrier between warps.
template <int D, int kRows, bool kNarrow>
__global__ void __launch_bounds__(kThreads, D <= 128 ? 2 : 1)
decode_mma(const __grid_constant__ CUtensorMap tm_k,
           const __grid_constant__ CUtensorMap tm_v,
           const __nv_bfloat16* __restrict__ q,
           const __nv_bfloat16* __restrict__ k,
           const __nv_bfloat16* __restrict__ v,
           const int* __restrict__ lengths, __nv_bfloat16* __restrict__ out,
           int S, int Hkv, int rep, int groups, int dt, const Strides st,
           float scale, const Pieces pw) {
  constexpr int Dp = padded_dim(D);
  constexpr int kFull = Dp / 32;                 // 32-column steps, then
  constexpr bool kTail = Dp % 32 != 0;           // one of 16 (W 16, 80)
  using L = MmaLayout<D, kRows>;
  using Tl = MmaTile<Dp>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int key0 = warp * kMmaKeys;              // the warp's keys in a tile
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
  // narrow: this warp's 8 rows of tile t's K and V, one cp.async group
  // (empty past the last tile, or where the warp's keys are all past the
  // length: it reads nothing there)
  const auto copy_own = [&](const Block& blk, int t) {
    const int first = blk.begin + t * kMmaTile + key0;
    if (t < blk.ntiles && first < blk.end) {
      const uint32_t dst = blk.base + L::kRing + (t % L::kStages) * Tl::kBytes +
                           key0 * Tl::kRowBytes;
      copy_keys<kMmaTile, Dp, Tl::kChunk>(
          dst, k + blk.b * st.kb + blk.kvh * st.kh, st.ks, first, blk.end, 0,
          dt, pw.k);
      copy_keys<kMmaTile, Dp, Tl::kChunk>(
          dst + Tl::kChunks * Tl::kBoxBytes,
          v + blk.b * st.vb + blk.kvh * st.vh, st.vs, first, blk.end, 0, dt,
          pw.v);
    }
    hopper::cp_async_commit();
  };
  if (!kNarrow && threadIdx.x == 0) {            // ahead of the first loads
    hopper::prefetch_tensor_map(&tm_k);
    hopper::prefetch_tensor_map(&tm_v);
  }
  const auto first_tiles = [&](const Block& blk) {
    if constexpr (kNarrow) {
      for (int t = 0; t < L::kStages; ++t) copy_own(blk, t);
    } else {
      tma_first(load)(blk);
    }
  };
  // the narrow copies wait on no barrier: no ring barriers for them
  const Block blk =
      start_block<1024>(lengths, S, Hkv, rep, groups, dt,
                        kNarrow ? 0 : L::kStages, smem_raw, first_tiles,
                        kMmaTile);
  float* qs = reinterpret_cast<float*>(blk.smem + L::kQ);
  q_rows_f32<__nv_bfloat16, Dp, kRows>(blk, q, st.qb, st.qh, qs);
  __syncthreads();                               // barriers and q ready
  const int rows = blk.rep;
  const int g = lane >> 2;                       // rows g and g + 8
  const int tq = lane & 3;                       // keys / columns 2 tq, + 1

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
    if constexpr (kNarrow) {
      hopper::cp_async_wait<L::kStages - 1>();   // this lane's copies of t
      __syncwarp();                              // and the warp's
    } else {
      mbar_wait(blk.full(s), (t / L::kStages) & 1);
    }
    const uint32_t kst = blk.base + L::kRing + s * Tl::kBytes;
    const uint32_t vst = kst + Tl::kChunks * Tl::kBoxBytes;
    const int first = blk.begin + t * kMmaTile + key0;   // the warp's key 0
    const int nvalid = min(kMmaKeys, blk.end - first);
    if (nvalid > 0) {                            // uniform across the warp
      if (!kNarrow && nvalid < kMmaKeys) {
        // rows past the length may hold anything (NaN): p = 0 must meet
        // zeros in P V (the narrow copies wrote zeros there)
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
#pragma unroll
      for (int p = 0; p < kFull; ++p) {
        uint32_t kb[4];
        ldsm_x4(kb, kst + Tl::at(lr, 4 * p + (lane >> 3)));
        mma_k16(sc, qa[2 * p], kb[0], kb[1]);
        mma_k16(sc, qa[2 * p + 1], kb[2], kb[3]);
      }
      if constexpr (kTail) {
        uint32_t kb[2];
        ldsm_x2(kb, kst + Tl::at(lr, 4 * kFull + ((lane >> 3) & 1)));
        mma_k16(sc, qa[2 * kFull], kb[0], kb[1]);
      }
      uint32_t pa[2];
      softmax_tile<kHalves>(sc, first, blk.end, tq, scale, m_r, l_r, o, pa);
      // O += P V, 8 columns of D per product
#pragma unroll
      for (int p = 0; p < kFull; ++p) {
        uint32_t vb[4];
        ldsm_x4_trans(vb, vst + Tl::at(lr, 4 * p + (lane >> 3)));
#pragma unroll
        for (int m = 0; m < 4; ++m) mma_k8(o[4 * p + m], pa[0], pa[1], vb[m]);
      }
      if constexpr (kTail) {
        uint32_t vb[2];
        ldsm_x2_trans(vb, vst + Tl::at(lr, 4 * kFull + ((lane >> 3) & 1)));
        mma_k8(o[4 * kFull], pa[0], pa[1], vb[0]);
        mma_k8(o[4 * kFull + 1], pa[0], pa[1], vb[1]);
      }
      if (!kNarrow && nvalid < kMmaKeys)         // the zeros, before TMA
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    }
    if constexpr (kNarrow) {
      __syncwarp();                              // the warp read stage s
      copy_own(blk, t + L::kStages);
    } else {
      release(blk, t, load);
    }
  }
  if constexpr (kNarrow) hopper::cp_async_wait<0>();
  __syncthreads();                               // the ring is free

  // this warp's (m, l, acc) of the group's rows into the ring
  float* wacc = reinterpret_cast<float*>(blk.smem + L::kRing);
  store_partials<kHalves>(wacc, rows, o, m_r, l_r);
  cg::cluster_group cluster = cg::this_cluster();
  merge_and_store<__nv_bfloat16, Dp>(
      cluster, blk, wacc, reinterpret_cast<float*>(blk.smem + L::kPart),
      out + (static_cast<size_t>(blk.b) * Hkv * rep + blk.row0) * dt, dt);
}

// ---------------------------------------------------------------------------
// bf16 past D 256: output slices, Q K^T in 128-column pieces
// ---------------------------------------------------------------------------
//
// O of 16 rows past 256 columns does not fit the registers beside Q's A
// fragments, so a block owns kSlice = 128 output columns: the grid's z axis
// runs over the slices, and each slice is a cluster of the cache's splits,
// as at D <= 256.  Per 64-key tile, warp w still takes keys 8 w .. 8 w + 7:
// S = Q K^T over the whole D as ceil(D / 128) pieces of 128 columns
// (mma.sync m16n8k16; Q's A fragments and K's B fragments by ldmatrix), the
// softmax of the D <= 256 kernels (softmax_tile), then O += P V over V's 8
// rows of the slice.  Each block recomputes S for its slice (at D 512 four
// times): K is read from L2 again, and the bits of S, m and l are the same
// in every slice.  The loads come in units of 8 rows x 128 columns (2 KB):
// per tile and piece, the group's q rows of the piece (one unit for 8 rows,
// two for 16) and the warp's own 8 K rows of it, then its 8 V rows of the
// slice.  A warp copies them by the narrow copies into its own ring of
// kWideUnits units, as far ahead as the units it still reads allow
// (cp.async groups, no barrier between warps).  Q goes through the ring
// beside K, so nothing of a block grows with D: every D runs, in 102-106
// KB of shared memory, two blocks a SM.  A copy of all of Q in shared
// memory, made once a block, saved the Q units' copies but capped D at
// what a block holds, and was no faster (tools/decode_ab.py, 32 / 8 heads
// at 543 of 576 keys: D 264 / 320 / 512 at 25.6 / 25.4 / 30.0 us against
// 25.0 / 24.5 / 28.8 streamed).

constexpr int kSlice = 128;                    // output columns of a block
constexpr int kUnitBytes = kMmaKeys * kSlice * 2;   // a unit: 2 KB
constexpr int kWideUnits = 6;                  // a warp's ring

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// Bytes from the block's 1024-aligned start: the merged partials (m, l,
// acc [kRows, kSlice]), then the warps' rings (after the loop the warps'
// partials).  kAhead: the units a warp keeps in flight, so that a K unit's
// slot and those of the kHalves Q units before it are not refilled while
// it is read.
template <int kRows>
struct WideLayout {
  static constexpr int kHalves = kRows / 8;     // q units a piece
  static constexpr int kAhead = kWideUnits - 1 - kHalves;
  static constexpr int kPart = 0;
  static constexpr int kRing = round_up(kRows * (kSlice + 2) * 4, 1024);
  static constexpr int kRingBytes = kWarps * kWideUnits * kUnitBytes;
  static constexpr int kBytes = 1024 + kRing + kRingBytes;
  static_assert(kWarps * kRows * (kSlice + 3) * 4 <= kRingBytes,
                "the warps' partials fit the ring");
};

// Byte offset of row r, 16-byte chunk c (of 128 columns) in a unit.
__device__ __forceinline__ uint32_t unit_at(int r, int c) {
  return hopper::swizzled((c / 8) * 1024 + r * 128 + (c % 8) * 16, 128);
}

template <int kRows>
__global__ void __launch_bounds__(kThreads, 2)
decode_wide(const __nv_bfloat16* __restrict__ q,
            const __nv_bfloat16* __restrict__ k,
            const __nv_bfloat16* __restrict__ v,
            const int* __restrict__ lengths, __nv_bfloat16* __restrict__ out,
            int S, int Hkv, int rep, int groups, int dt, const Strides st,
            float scale, const Pieces pw) {
  using L = WideLayout<kRows>;
  constexpr int kHalves = L::kHalves;
  constexpr int kPer = kHalves + 1;             // units a piece: Q, then K
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int key0 = warp * kMmaKeys;
  const int col0 = blockIdx.z * kSlice;
  const int pieces = (dt + kSlice - 1) / kSlice;
  const int per_tile = pieces * kPer + 1;        // + V's slice
  const auto slot = [&](const Block& blk, int u) {
    return blk.base + L::kRing +
           (warp * kWideUnits + u % kWideUnits) * kUnitBytes;
  };
  // unit u of this warp into its ring slot, one cp.async group (empty past
  // the last unit, or where the warp's keys are all past the length): of
  // tile u / per_tile, piece p's Q halves and K rows, then V's slice
  const auto issue = [&](const Block& blk, int u) {
    const int j = u / per_tile;
    const int part = u - j * per_tile;
    const int first = blk.begin + j * kMmaTile + key0;
    if (j < blk.ntiles && first < blk.end) {
      const uint32_t dst = slot(blk, u);
      const int p = part / kPer;
      const int h = part - p * kPer;
      if (part == per_tile - 1)
        copy_keys<kMmaKeys, kSlice, 64>(
            dst, v + blk.b * st.vb + blk.kvh * st.vh, st.vs, first, blk.end,
            col0, dt, pw.v);
      else if (h < kHalves)                      // q rows 8 h .. 8 h + 7
        copy_keys<kMmaKeys, kSlice, 64>(
            dst, q + blk.b * st.qb + blk.row0 * st.qh, st.qh, 8 * h, blk.rep,
            p * kSlice, dt, pw.q);
      else
        copy_keys<kMmaKeys, kSlice, 64>(
            dst, k + blk.b * st.kb + blk.kvh * st.kh, st.ks, first, blk.end,
            p * kSlice, dt, pw.k);
    }
    hopper::cp_async_commit();
  };
  const Block blk = start_block<1024>(
      lengths, S, Hkv, rep, groups, dt, 0, smem_raw,
      [&](const Block& b) {
        for (int u = 0; u < L::kAhead; ++u) issue(b, u);
      },
      kMmaTile);
  const int tq = lane & 3;
  const int lr = lane & 7;                       // ldmatrix row of this lane

  float o[kSlice / 8][4];
#pragma unroll
  for (int n = 0; n < kSlice / 8; ++n)
    o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY};
  float l_r[2] = {0.f, 0.f};
  float sc[4] = {0.f, 0.f, 0.f, 0.f};
  uint32_t pa[2] = {0u, 0u};
  const int units = blk.ntiles * per_tile;
  for (int u = 0; u < units; ++u) {
    hopper::cp_async_wait<L::kAhead - 1>();      // this lane's copies of u
    __syncwarp();                                // and the warp's; u - 1 read
    // into the slot of unit u - kHalves - 1, read last at u - 1
    issue(blk, u + L::kAhead);
    const int j = u / per_tile;
    const int part = u - j * per_tile;
    const int first = blk.begin + j * kMmaTile + key0;
    if (first >= blk.end) continue;              // uniform across the warp
    const uint32_t src = slot(blk, u);
    if (part == per_tile - 1) {
      // O += P V over the slice, 8 columns per product
#pragma unroll
      for (int p = 0; p < kSlice / 32; ++p) {
        uint32_t vb[4];
        ldsm_x4_trans(vb, src + unit_at(lr, 4 * p + (lane >> 3)));
#pragma unroll
        for (int m = 0; m < 4; ++m) mma_k8(o[4 * p + m], pa[0], pa[1], vb[m]);
      }
    } else if (part % kPer == kHalves) {
      // S (+)= Q[:, c0 .. c0 + 127] K[keys, c0 .. c0 + 127]^T, 32 columns a
      // step, the steps past dt skipped (zeros on both sides); Q's rows are
      // the kHalves units before this one (ldmatrix x4: lane l gives row
      // l & 7 of half l >> 3 & 1, columns + 8 (l >> 4); with one half, x2:
      // rows 8..15 are zero)
      const int piece = part / kPer;
      if (piece == 0) sc[0] = sc[1] = sc[2] = sc[3] = 0.f;
      const int c0 = piece * kSlice;
      const uint32_t qsrc =
          slot(blk, u - kHalves + (kHalves == 2 ? (lane >> 3) & 1 : 0));
#pragma unroll
      for (int p = 0; p < kSlice / 32; ++p) {
        if (c0 + 32 * p >= dt) break;
        uint32_t qa0[4], qa1[4], kb[4];
        if constexpr (kHalves == 2) {
          ldsm_x4(qa0, qsrc + unit_at(lr, 4 * p + (lane >> 4)));
          ldsm_x4(qa1, qsrc + unit_at(lr, 4 * p + 2 + (lane >> 4)));
        } else {
          uint32_t a[2];
          ldsm_x2(a, qsrc + unit_at(lr, 4 * p + ((lane >> 3) & 1)));
          qa0[0] = a[0], qa0[1] = 0u, qa0[2] = a[1], qa0[3] = 0u;
          ldsm_x2(a, qsrc + unit_at(lr, 4 * p + 2 + ((lane >> 3) & 1)));
          qa1[0] = a[0], qa1[1] = 0u, qa1[2] = a[1], qa1[3] = 0u;
        }
        ldsm_x4(kb, src + unit_at(lr, 4 * p + (lane >> 3)));
        mma_k16(sc, qa0, kb[0], kb[1]);
        mma_k16(sc, qa1, kb[2], kb[3]);
      }
      if (piece == pieces - 1)
        softmax_tile<kHalves>(sc, first, blk.end, tq, scale, m_r, l_r, o, pa);
    }
    // a Q unit is read with the K unit after it
  }
  hopper::cp_async_wait<0>();
  __syncthreads();                               // the rings are free

  float* wacc = reinterpret_cast<float*>(blk.smem + L::kRing);
  store_partials<kHalves>(wacc, blk.rep, o, m_r, l_r);
  cg::cluster_group cluster = cg::this_cluster();
  merge_and_store<__nv_bfloat16, kSlice>(
      cluster, blk, wacc, reinterpret_cast<float*>(blk.smem + L::kPart),
      out + (static_cast<size_t>(blk.b) * Hkv * rep + blk.row0) * dt + col0,
      min(kSlice, dt - col0));
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// Launches `fn` on a (clusters, splits, slices) grid in clusters of (1,
// splits, 1) with `smem` bytes of shared memory, after setting, once per
// kernel and before any capture, that size and clusters of more than 8
// blocks.
template <auto fn, typename... Args>
int launch_cluster(int smem, int clusters, int slices, int S,
                   cudaStream_t stream, Args... args) {
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
  cfg.gridDim = dim3(clusters, nsplit, slices);
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

// The narrow copies' piece widths for q, k and v (bf16) of dt columns.
Pieces pieces_of(const void* q, const void* k, const void* v, int dt,
                 const Strides& st) {
  const long long qs[2] = {st.qb, st.qh};
  const long long ks[3] = {st.kb, st.ks, st.kh};
  const long long vs[3] = {st.vb, st.vs, st.vh};
  return {hopper::piece_elems(q, dt, qs, 2), hopper::piece_elems(k, dt, ks, 3),
          hopper::piece_elems(v, dt, vs, 3)};
}

// One cluster per (batch row, kv head, group of at most kGroupRows q heads):
// bf16 on the tensor cores (8 or 16 rows a product; kNarrow: the tiles by
// the narrow copies), f32 on FMA (4 or 16 rows in registers).  D: the
// instance's width; dt: the true head dim.
template <typename T, int D, bool kNarrow>
int launch(const void* q, const void* k, const void* v, const void* lengths,
           void* out, int B, int S, int Hkv, int rep, int dt,
           const Strides& st, float scale, cudaStream_t stream) {
  constexpr bool kBf16 = sizeof(T) == 2;
  static_assert(kBf16 || !kNarrow, "f32 has no narrow copies");
  constexpr int Dp = padded_dim(D);
  const CUtensorMapDataType dtype = kBf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                          : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const int groups = (rep + kGroupRows - 1) / kGroupRows;
  const int rows = rep < kGroupRows ? rep : kGroupRows;
  // the tensor-core path reads swizzled column boxes of 64 keys, the FMA
  // path plain rows of 32 keys; either reaches past the maps' dt columns to
  // Dp, where TMA writes zeros
  const int box_d = kBf16 ? MmaTile<Dp>::kChunk : Dp;
  const int box_s = kBf16 ? kMmaTile : kTile;
  const CUtensorMapSwizzle swizzle =
      !kBf16 ? CU_TENSOR_MAP_SWIZZLE_NONE
             : (MmaTile<Dp>::kRowBytes == 128
                    ? CU_TENSOR_MAP_SWIZZLE_128B
                    : (MmaTile<Dp>::kRowBytes == 64
                           ? CU_TENSOR_MAP_SWIZZLE_64B
                           : CU_TENSOR_MAP_SWIZZLE_32B));
  CUtensorMap mk = {}, mv = {};
  Pieces pw = {};
  if constexpr (kNarrow) {
    pw = pieces_of(q, k, v, dt, st);
  } else {
    int rc = hopper::tensor_map(&mk, dtype, sizeof(T), k, B, S, Hkv, dt,
                                st.kb, st.ks, st.kh, box_d, box_s, swizzle);
    if (rc == 0)
      rc = hopper::tensor_map(&mv, dtype, sizeof(T), v, B, S, Hkv, dt, st.vb,
                              st.vs, st.vh, box_d, box_s, swizzle);
    if (rc) return rc;
  }
  const auto* qp = static_cast<const T*>(q);
  const auto* lp = static_cast<const int*>(lengths);
  auto* op = static_cast<T*>(out);
  const int clusters = B * Hkv * groups;
  if constexpr (kBf16) {
    const auto* kp = static_cast<const T*>(k);
    const auto* vp = static_cast<const T*>(v);
    if (rows <= 8) {
      constexpr int kBytes = MmaLayout<D, 8>::kBytes;
      return launch_cluster<decode_mma<D, 8, kNarrow>>(
          kBytes, clusters, 1, S, stream, mk, mv, qp, kp, vp, lp, op,
          S, Hkv, rep, groups, dt, st, scale, pw);
    }
    constexpr int kBytes = MmaLayout<D, 16>::kBytes;
    return launch_cluster<decode_mma<D, 16, kNarrow>>(
        kBytes, clusters, 1, S, stream, mk, mv, qp, kp, vp, lp, op, S,
        Hkv, rep, groups, dt, st, scale, pw);
  } else {
    if (rows <= 4) {
      constexpr int kBytes = FmaLayout<D, 4>::kBytes;
      return launch_cluster<decode_fma<D, 4>>(
          kBytes, clusters, 1, S, stream, mk, mv, qp, lp, op, S, Hkv,
          rep, groups, dt, st.qb, st.qh, scale);
    }
    constexpr int kBytes = FmaLayout<D, kGroupRows>::kBytes;
    return launch_cluster<decode_fma<D, kGroupRows>>(
        kBytes, clusters, 1, S, stream, mk, mv, qp, lp, op, S, Hkv,
        rep, groups, dt, st.qb, st.qh, scale);
  }
}

// The instance of the width that holds D rounded up to 8.
template <typename T, bool kNarrow>
int dispatch(int D, const void* q, const void* k, const void* v,
             const void* lengths, void* out, int B, int S, int Hkv, int rep,
             const Strides& st, float scale, cudaStream_t stream) {
#define REPRO_DECODE_WIDTH(W)                                              \
  case W:                                                                  \
    return launch<T, W, kNarrow>(q, k, v, lengths, out, B, S, Hkv, rep, D, \
                                 st, scale, stream);
  switch (hopper::attention_width(round_up(D, 8))) {
    REPRO_DECODE_WIDTH(16)
    REPRO_DECODE_WIDTH(32)
    REPRO_DECODE_WIDTH(64)
    REPRO_DECODE_WIDTH(80)
    REPRO_DECODE_WIDTH(96)
    REPRO_DECODE_WIDTH(112)
    REPRO_DECODE_WIDTH(128)
    REPRO_DECODE_WIDTH(192)
    REPRO_DECODE_WIDTH(256)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_DECODE_WIDTH
}

// bf16 past D 256: decode_wide, one cluster per (batch row, kv head, group
// of at most kGroupRows q heads, 128 output columns).
int launch_wide(const void* q, const void* k, const void* v,
                const void* lengths, void* out, int B, int S, int Hkv,
                int rep, int dt, const Strides& st, float scale,
                cudaStream_t stream) {
  const int groups = (rep + kGroupRows - 1) / kGroupRows;
  const int rows = rep < kGroupRows ? rep : kGroupRows;
  const int clusters = B * Hkv * groups;
  const int slices = (dt + kSlice - 1) / kSlice;
  const Pieces pw = pieces_of(q, k, v, dt, st);
  using T = __nv_bfloat16;
  const auto* qp = static_cast<const T*>(q);
  const auto* kp = static_cast<const T*>(k);
  const auto* vp = static_cast<const T*>(v);
  const auto* lp = static_cast<const int*>(lengths);
  auto* op = static_cast<T*>(out);
  if (rows <= 8)
    return launch_cluster<decode_wide<8>>(
        WideLayout<8>::kBytes, clusters, slices, S, stream, qp, kp, vp, lp,
        op, S, Hkv, rep, groups, dt, st, scale, pw);
  return launch_cluster<decode_wide<16>>(
      WideLayout<16>::kBytes, clusters, slices, S, stream, qp, kp, vp, lp,
      op, S, Hkv, rep, groups, dt, st, scale, pw);
}

// f32 at any other head dim or stride: the CUDA-core instance
// (attention_any.cuh).
int launch_any(const void* q, const void* k, const void* v,
               const void* lengths, void* out, int B, int S, int H, int Hkv,
               int D, const Strides& st, float scale, cudaStream_t stream) {
  const attn_any::Args<float> a{
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out),
      static_cast<const int*>(lengths), B, 1, S, H, Hkv, D, st.qb, 0, st.qh,
      st.kb, st.ks, st.kh, st.vb, st.vs, st.vh, 0, 0, 0, scale};
  return attn_any::launch<float, true>(a, stream);
}

// The instance a call takes (see "Head dims"): 0 the TMA instances, 1
// decode_mma with narrow copies, 2 decode_wide, 3 the CUDA-core instance
// (f32 only);
// -1 for arguments the entry point refuses.  strides: as
// decode_attention_fwd's (q's two, then k's three, then v's).
int route_of(int dtype, const void* k, const void* v, int D,
             const long long* strides) {
  if ((dtype != 0 && dtype != 1) || D < 1) return -1;
  const void* kv[2] = {k, v};
  if (attn_any::aligned_rows(dtype == 0 ? 4 : 2, kv, 2, strides + 2, 6) &&
      hopper::attention_width(D) != 0)
    return 0;
  if (dtype == 0) return 3;
  return D > 256 ? 2 : 1;
}

}  // namespace

// Splits (blocks per cluster) for a cache of S keys (of every instance but
// the CUDA-core one, which takes one block per row and head group).
extern "C" int decode_attention_splits(int S) {
  return S > 0 ? num_splits(S) : 0;
}

// dtype: 0 = float32, 1 = bfloat16.  q [B, H, D], k/v [B, S, Hkv, D] through
// strides (qb, qh, kb, ks, kh, vb, vs, vh; unit stride over D), lengths [B]
// int32, out [B, H, D] contiguous.  Any D >= 1 (see "Head dims"), H any
// multiple of Hkv; `scale` is 1/sqrt(D).
extern "C" int decode_attention_fwd(int dtype, const void* q, const void* k,
                                    const void* v, const void* lengths,
                                    void* out, int B, int S, int H, int Hkv,
                                    int D, const long long* strides,
                                    float scale, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  const int route = route_of(dtype, k, v, D, strides);
  if (route < 0 || Hkv <= 0 || H % Hkv)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides st{strides[0], strides[1], strides[2], strides[3],
                   strides[4], strides[5], strides[6], strides[7]};
  const auto s = static_cast<cudaStream_t>(stream);
  const int rep = H / Hkv;
  switch (route) {
    case 0:
      return dtype == 0
                 ? dispatch<float, false>(D, q, k, v, lengths, out, B, S, Hkv,
                                          rep, st, scale, s)
                 : dispatch<__nv_bfloat16, false>(D, q, k, v, lengths, out,
                                                  B, S, Hkv, rep, st, scale,
                                                  s);
    case 1:
      return dispatch<__nv_bfloat16, true>(D, q, k, v, lengths, out, B, S,
                                           Hkv, rep, st, scale, s);
    case 2:
      return launch_wide(q, k, v, lengths, out, B, S, Hkv, rep, D, st, scale,
                         s);
    default:
      return launch_any(q, k, v, lengths, out, B, S, H, Hkv, D, st, scale, s);
  }
}

// Which instance decode_attention_fwd would run for these tensors (the
// route_of codes); tests hold the wrapper's ``route`` to it.
extern "C" int decode_attention_route(int dtype, const void* k, const void* v,
                                      int D, const long long* strides) {
  return route_of(dtype, k, v, D, strides);
}

extern "C" const char* decode_attention_error_string(int code) {
  return hopper::error_string(code);
}
