// Attention at any head dim, on the CUDA cores: the instance of the two
// attention kernels for the f32 shapes their TMA instances do not take.  It
// serves f32 flash (flash_attention.cu) and f32 flash-decode
// (decode_attention.cu) at those shapes and nothing else: the tensor cores
// have no f32 product without TF32 rounding.  bf16 runs every shape on the
// tensor cores (flash on wgmma, flash_fwd_wide; flash-decode on mma.sync,
// decode_mma's narrow copies and decode_wide).
//
// The f32 TMA instances load rows by TMA, which needs 16-byte global
// strides and pointers, and hold O in registers up to D 256; their widths
// are multiples of 8.  So an f32 head dim that is no multiple of 8 (D 4,
// 20, 100) or past 256 (264, 320, 512), and tensors whose strides or
// pointers are not 16-byte aligned, run here:
//   - loads: element by element (no alignment asked), converted to f32 into
//     zero-padded shared tiles of 128 keys; the scores stream Q and K
//     through shared memory in pieces of kPiece = 32 columns of D, so no
//     tile grows with D;
//   - a grid axis over slices of kSlice = 128 output columns: each block
//     computes the scores over the whole D and P V for its slice of V's and
//     O's columns (D 512: four slices, each repeating Q K^T), so O stays at
//     kRows x 128 f32 whatever D is;
//   - the softmax and its rounding are the reference's: f32 scores times
//     1/sqrt(D) of the true D (the caller's scale), the online softmax per
//     128-key tile (the reference's block_k), l summed from f32 p, P V
//     with f32 sums, out = acc / max(l, 1e-30); masked scores are -1e30
//     and keys past the sequence (or the row's length) -inf, as in the
//     reference.
// Flash: a block owns 64 query rows of one (batch row, q head), eight per
// warp; tiles that the mask skips wholly are not visited (the rule of
// flash_attention.cu, "Skipped tiles").  Flash-decode: a block owns up to
// eight q heads of one kv head of one batch row (one per warp; more q heads
// per kv head take more blocks), and walks the row's live keys in one
// block: no split of the cache, so a row's bits depend on its own inputs
// alone (never on B), and the launch shape on B, S and the widths.
// Grids depend on the shapes alone (a CUDA graph can capture a call).
//
// Bound: the same as the TMA instances' (4 D flops per unmasked (q, k)
// pair, each of q, k, v and out moved once).  This instance gives up the
// tensor cores and the copy engine for generality, and recomputes Q K^T
// once per output slice: PERF.md has its times against the bound.

#pragma once

#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

namespace attn_any {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kKeys = 128;         // keys per tile: the reference's block
constexpr int kKeyLanes = kKeys / 32;   // a lane's keys of a tile
constexpr int kPiece = 32;         // columns of q and k per step of Q K^T
constexpr int kSlice = 128;        // output columns per block, 4 a lane
constexpr int kCols = kSlice / 32;
constexpr float kMasked = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
// p as P V takes it: rounded to v's dtype (f32: as it is)
__device__ __forceinline__ float as_v(float p, const float*) { return p; }

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// A call: q [B, Sq, H, D] (flash) or [B, H, D] (decode: Sq = 1, q_ss
// unused), k/v [B, Skv, Hkv, D] through their strides (elements), out
// contiguous like q; lengths [B] (decode: the live keys of each row).
template <typename T>
struct Args {
  const T* q;
  const T* k;
  const T* v;
  T* out;
  const int* lengths;
  int B, Sq, Skv, H, Hkv, D;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  int causal, has_window, window;
  float scale;
};

// Shared memory, in floats: Q's piece [kRows][kPiece + 1], K's piece
// [kKeys][kPiece + 1] (odd pitches: a lane's column reads hit distinct
// banks), V's slice [kKeys][kSlice], P [kRows][kKeys]: 124 KB for flash's
// 64 rows, 88 KB for decode's 8.
template <int kRows>
struct Smem {
  static constexpr int kLd = kPiece + 1;
  static constexpr int kK = kRows * kLd;
  static constexpr int kV = kK + kKeys * kLd;
  static constexpr int kP = kV + kKeys * kSlice;
  static constexpr int kBytes = (kP + kRows * kKeys) * 4;
};

template <typename T, bool kDecode>
__global__ void __launch_bounds__(kThreads)
attention_any(const Args<T> a) {
  constexpr int kRPW = kDecode ? 1 : 8;          // rows a warp owns
  constexpr int kRows = kWarps * kRPW;
  using L = Smem<kRows>;
  extern __shared__ __align__(16) float sm[];
  float* Qs = sm;
  float* Ks = sm + L::kK;
  float* Vs = sm + L::kV;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* Pw = sm + L::kP + warp * kRPW * kKeys;
  const int col0 = blockIdx.z * kSlice;
  const int rep = a.H / a.Hkv;
  const int off = a.Skv - a.Sq;

  // the block's rows: q rows (flash) or q heads (decode), and its keys
  int b, hk, nrows, klen, kt_begin, kt_end, q0 = 0;
  const T* qb;
  T* ob;
  long long q_rs, o_rs;
  if constexpr (kDecode) {
    const int groups = (rep + kRows - 1) / kRows;
    b = blockIdx.x / (a.Hkv * groups);
    const int hg = blockIdx.x - b * a.Hkv * groups;
    hk = hg / groups;
    const int grp = hg - hk * groups;
    const int h0 = hk * rep + grp * kRows;
    nrows = min(kRows, rep - grp * kRows);
    qb = a.q + b * a.q_sb + h0 * a.q_sh;
    q_rs = a.q_sh;
    ob = a.out + (static_cast<long long>(b) * a.H + h0) * a.D;
    o_rs = a.D;
    klen = min(max(a.lengths[b], 0), a.Skv);
    kt_begin = 0;
    kt_end = (klen + kKeys - 1) / kKeys;
  } else {
    q0 = (gridDim.x - 1 - blockIdx.x) * kRows;   // longest rows first
    b = blockIdx.y / a.H;
    const int h = blockIdx.y - b * a.H;
    hk = h / rep;
    nrows = min(kRows, a.Sq - q0);
    qb = a.q + b * a.q_sb + h * a.q_sh + q0 * a.q_ss;
    q_rs = a.q_ss;
    ob = a.out + ((static_cast<long long>(b) * a.Sq + q0) * a.H + h) * a.D;
    o_rs = static_cast<long long>(a.H) * a.D;
    klen = a.Skv;
    // the tiles a row of the block sees (flash_attention.cu's kv_tiles)
    const int q_lo = q0 + off, q_hi = q0 + nrows - 1 + off;
    kt_begin = 0;
    kt_end = (a.Skv + kKeys - 1) / kKeys;
    if (a.causal && q_lo >= 0 && (!a.has_window || a.window >= 1)) {
      kt_end = min(kt_end, q_hi / kKeys + 1);
      if (a.has_window) kt_begin = max(0, (q_lo - a.window + 1) / kKeys);
    }
  }
  const T* kb = a.k + b * a.k_sb + hk * a.k_sh;
  const T* vb = a.v + b * a.v_sb + hk * a.v_sh;

  float m[kRPW], l[kRPW], acc[kRPW][kCols];
#pragma unroll
  for (int r = 0; r < kRPW; ++r) {
    m[r] = kMasked;
    l[r] = 0.f;
#pragma unroll
    for (int u = 0; u < kCols; ++u) acc[r][u] = 0.f;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kKeys;
    // scores of the warp's rows against keys lane + 32 j
    float s[kRPW][kKeyLanes];
#pragma unroll
    for (int r = 0; r < kRPW; ++r)
#pragma unroll
      for (int j = 0; j < kKeyLanes; ++j) s[r][j] = 0.f;
    for (int d0 = 0; d0 < a.D; d0 += kPiece) {
      __syncthreads();               // the last piece's (and tile's) readers
      for (int i = threadIdx.x; i < kRows * kPiece; i += kThreads) {
        const int r = i / kPiece, c = i - r * kPiece;
        Qs[r * L::kLd + c] = r < nrows && d0 + c < a.D
                                 ? to_f(qb[r * q_rs + d0 + c])
                                 : 0.f;
      }
      for (int i = threadIdx.x; i < kKeys * kPiece; i += kThreads) {
        const int r = i / kPiece, c = i - r * kPiece;
        Ks[r * L::kLd + c] = k0 + r < klen && d0 + c < a.D
                                 ? to_f(kb[(k0 + r) * a.k_ss + d0 + c])
                                 : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int c = 0; c < kPiece; ++c) {
        float kv[kKeyLanes];
#pragma unroll
        for (int j = 0; j < kKeyLanes; ++j)
          kv[j] = Ks[(lane + 32 * j) * L::kLd + c];
#pragma unroll
        for (int r = 0; r < kRPW; ++r) {
          const float qv = Qs[(warp * kRPW + r) * L::kLd + c];
#pragma unroll
          for (int j = 0; j < kKeyLanes; ++j)
            s[r][j] = fmaf(qv, kv[j], s[r][j]);
        }
      }
    }

    // mask, online softmax, p (as v's dtype) of the warp's rows
#pragma unroll
    for (int r = 0; r < kRPW; ++r) {
      const int qpos = q0 + warp * kRPW + r + off;
      float p[kKeyLanes], mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kKeyLanes; ++j) {
        const int kpos = k0 + lane + 32 * j;
        const bool masked = (a.causal && kpos > qpos) ||
                            (a.has_window && kpos <= qpos - a.window);
        const float x = masked ? kMasked : s[r][j] * a.scale;
        p[j] = kpos >= klen ? -INFINITY : x;
        mx = fmaxf(mx, p[j]);
      }
      const float m_new = fmaxf(m[r], warp_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kKeyLanes; ++j) {
        p[j] = expf(p[j] - m_new);
        sum += p[j];
        Pw[r * kKeys + lane + 32 * j] = as_v(p[j], a.v);
      }
      const float alpha = expf(m[r] - m_new);
      l[r] = l[r] * alpha + warp_sum(sum);
      m[r] = m_new;
#pragma unroll
      for (int u = 0; u < kCols; ++u) acc[r][u] *= alpha;
    }

    // V's slice of this tile (zero past the keys: p = 0 meets no NaN),
    // then acc += p v
    for (int i = threadIdx.x; i < kKeys * kSlice; i += kThreads) {
      const int r = i / kSlice, c = i - r * kSlice;
      Vs[i] = k0 + r < klen && col0 + c < a.D
                  ? to_f(vb[(k0 + r) * a.v_ss + col0 + c])
                  : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kKeys; ++j) {
      float vv[kCols];
#pragma unroll
      for (int u = 0; u < kCols; ++u) vv[u] = Vs[j * kSlice + lane + 32 * u];
#pragma unroll
      for (int r = 0; r < kRPW; ++r) {
        const float pj = Pw[r * kKeys + j];
#pragma unroll
        for (int u = 0; u < kCols; ++u) acc[r][u] = fmaf(pj, vv[u], acc[r][u]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRPW; ++r) {
    const int row = warp * kRPW + r;
    if (row >= nrows) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int u = 0; u < kCols; ++u) {
      const int col = col0 + lane + 32 * u;
      if (col < a.D) store(ob + row * o_rs + col, acc[r][u] * inv);
    }
  }
}

// The launch: flash, one block per (64 q rows, batch row x q head, output
// slice), the longest rows first; decode, one per (batch row x kv head x
// group of 8 q heads, output slice).
template <typename T, bool kDecode>
int launch(const Args<T>& a, cudaStream_t stream) {
  constexpr int kRows = kWarps * (kDecode ? 1 : 8);
  constexpr int kBytes = Smem<kRows>::kBytes;
  static const cudaError_t ready = cudaFuncSetAttribute(
      attention_any<T, kDecode>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kBytes);
  if (ready != cudaSuccess) return static_cast<int>(ready);
  const int slices = (a.D + kSlice - 1) / kSlice;
  const int rep = a.H / a.Hkv;
  const dim3 grid =
      kDecode ? dim3(a.B * a.Hkv * ((rep + kRows - 1) / kRows), 1, slices)
              : dim3((a.Sq + kRows - 1) / kRows, a.B * a.H, slices);
  attention_any<T, kDecode><<<grid, kThreads, kBytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Whether the TMA instances take these tensors: 16-byte aligned pointers
// and strides (in elements of `el` bytes).
inline bool aligned_rows(int el, const void* const* ptrs, int nptrs,
                         const long long* strides, int nstrides) {
  for (int i = 0; i < nptrs; ++i)
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16) return false;
  for (int i = 0; i < nstrides; ++i)
    if (strides[i] * el % 16) return false;
  return true;
}

}  // namespace attn_any
