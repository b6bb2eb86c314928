// Flash attention (prefill) for Hopper (sm_90a), CUDA C++.
//
// Replaces src/repro/kernels/flash_attention.py::_flash_kernel
// (flash_attention.py:27, pallas_call at flash_attention.py:93).
//
// What it computes.  q [B, Sq, H, D], k/v [B, Skv, Hkv, D] -> out [B, Sq, H, D]:
// softmax(q k^T / sqrt(D) + mask) v per (batch row, q head), where q head h
// reads kv head h / (H / Hkv) (GQA) and query i sits at absolute position
// qpos = i + (Skv - Sq) (right-aligned to the keys).  A key is masked when
// kpos > qpos (causal) or kpos <= qpos - window (sliding window); a masked
// score is -1e30, as in the reference.  The softmax is the reference's blocked
// online softmax, in f32: per KV tile, m_new = max(m, rowmax s),
// p = exp(s - m_new), alpha = exp(m - m_new), l = l * alpha + rowsum p (f32 p),
// acc = acc * alpha + p @ v with p rounded to v's dtype first and an f32
// accumulator; out = acc / max(l, 1e-30), rounded once to the output dtype.
// The bf16 kernel tiles by 128 x 128, the reference's own block_q = block_k =
// 128 (flash_attention.py:72), so p is rounded to bf16 at the same running
// max as in the TPU kernel; at D 192 it takes 64-key tiles (see HopperSmem),
// which moves where p is rounded by at most one bf16 step.  The f32 kernel
// tiles by 64 x 64, which moves only the summation order (f32 p is not
// rounded).
//
// Skipped tiles.  A KV tile that is masked for every row of the q tile (above
// the diagonal, or wholly outside the window) is not visited.  That is exact:
// in the reference such a tile either leaves m, l and acc unchanged (a row
// that has seen a valid key gets p = exp(-1e30 - m) = 0 and alpha = 1) or
// comes before the row's first valid key, and then everything it added is
// wiped at that key by alpha = exp(-1e30 - m) = 0.  Every row has at least its
// own key when the mask is causal, qpos >= 0 and window >= 1; in any other
// case no tile is skipped and the reference's arithmetic is repeated on all.
//
// Bound on this card.  The work is the unmasked (q, k) pairs summed over all
// B * H heads, 4 * D flops each (q k^T and p v), against bytes of q, k, v and
// out read or written once:
//   max(pairs * 4 * D / 989e12 (bf16 dense),  bytes / 3.35e12)
// (the published dense bf16 and memory rates of an H100 SXM at its 700 W
// limit).  At H 32, Hkv 8, D 128, causal, the bytes bound it below S ~ 740
// and the operations above (S 2048: 0.0348 ms): prefill is a tensor-core
// kernel, and on Hopper only wgmma reaches the tensor cores' rate.
//
// bf16 (flash_fwd_wgmma): FlashAttention-3 in its plain form.  A block of
// two warpgroups (8 warps) owns 128 query rows of one (batch row, q head):
//   - loads: Q once, then the 128-key K and V tiles into a ring of kStages
//     stages, each by TMA (cp.async.bulk.tensor) on full mbarriers (K and V
//     of a stage have one each, so the scores start before V lands).  Thread
//     0 issues Q and the first kStages tiles; after that the last warp to
//     release a stage (empty mbarrier, and a count in shared memory that
//     elects it) refills it at once, so no warpgroup waits for the other to
//     issue a load.  The tensor maps describe the public [B, S, H, D] layout
//     through the caller's strides, with the widest swizzle a row of D (or of
//     64 of its elements) fills; rows past a sequence arrive as zeros.  There
//     is no producer warp: a ninth warp puts three warps on one scheduler,
//     which caps every thread at 168 registers, and setmaxnreg did not lift
//     ptxas's cap (the wgmma were serialised for want of registers); with 8
//     warps a consumer thread may hold the ~190 it needs.
//   - compute: each warpgroup takes 64 query rows, so every K/V tile is read
//     from L2 once for 128 rows.  S = Q K^T is wgmma m64n128k16 with Q and K
//     from shared memory; the online softmax runs on the accumulator
//     registers (a row's 128 scores sit in the 4 lanes of a quad, 32 each;
//     exp2 on the special-function unit, the scale folded in); p, rounded to
//     bf16, becomes the register A operand of O += P V, wgmma m64nDk16 with V
//     read MN-major from shared memory (the transpose bit: no transposed copy
//     of V).  Software pipeline: step j issues S of tile j and P V of tile
//     j - 1, then runs tile j's softmax while P V still runs.  Ping-pong: the
//     warpgroups take turns (two named barriers) to issue their products, so
//     that one's softmax runs while the other's products hold the tensor
//     cores.  The masks are computed only on the tiles that straddle the
//     diagonal, the window edge or the end of the keys.
//   The longest q tiles are launched first.
// Head dims.  Every D >= 1 runs.  A D that is a multiple of 8 from 8 to 256,
// with 16-byte aligned pointers and strides (every served shape), runs in the
// smallest of the instances W in {16, 32, 64, 80, 96, 112, 128, 192, 256} that
// holds it.  In bf16, any other D up to 256 (one that leaves a row no whole
// number of 16 bytes: D 4, 20, 100) and any unaligned tensor run in the same
// kernel at the W that holds D rounded up to 8, with its tiles filled by
// narrow copies (kNarrow): warpgroup 1's 128 threads copy Q, K and V rows by
// cp.async of the widest piece each tensor's rows, strides and pointer allow
// (hopper::copy_tile: 16, 8 or 4 bytes, or 2-byte loads and st.shared),
// into the very layout and swizzle TMA writes, zeros past D and past the
// sequence; the wgmma, softmax and ping-pong code is the TMA instance's, so
// at a D both take, the two give the same bits (tests/test_torch_cuda.py).
// Warpgroup 1 issues the refills (see load_kv): no producer warp, for the
// registers' sake as above.  Past D 256 (O would not fit the registers) bf16
// runs in flash_fwd_wide: a grid axis over 128-column slices of O, Q K^T on
// wgmma over the whole D in 64-column pieces, 128-key tiles (p rounded
// where the reference rounds it: 64-key tiles put D 4's output 1.3 % of a
// row's max from the plain version, PERF.md), narrow copies for every
// tensor.  f32 at any D or stride the FMA instances do not take runs in the
// CUDA-core instance of attention_any.cuh.
// Bound at those shapes (S 512, 32 / 8 heads): D 4-100 by the bytes (q, k,
// v and out are 0.3-5 MB), D 264-512 by the operations; the narrow route
// pays its copies' issue, flash_fwd_wide a block barrier per 64 columns of
// D and Q K^T once per output slice (D 512: four times).  What the A/B
// runs showed (tools/flash_ab.py --dims, against the CUDA-core instance
// that bf16 took at these shapes before; 32 / 8 heads, S 512, causal):
// D 4 / 20 / 100 at 11.7 / 14.6 / 32.1 us (was 124 / 126 / 212; SDPA 23 /
// 24 / 41), D 264 / 320 / 512 at 107 / 111 / 174 (was 873 / 954 / 1832;
// SDPA 459 / 496 / 654); the TMA instances' times and bits unchanged.
// In the TMA instances the tensor maps have the true D columns and the
// boxes reach W (or past it), so TMA writes zeros past D: they add nothing to Q
// K^T, give output columns that are not stored, and no byte past D is read from
// device memory.  The softmax scale is 1/sqrt(D) of the true D. A row of 16 /
// 32 / 64 elements fills a 32 / 64 / 128-byte swizzle span: D = 16 and 32 are
// one column box, 64, 128, 192 and 256 are boxes of 64, 96 three boxes of 32
// and 80 five boxes of 16 (the products over them are one wgmma per box, N =
// the box's width).  D = 112 is 7 x 16, which wgmma takes, but its 224-byte
// rows fill no swizzle span: its tiles are D = 128's.  D = 192 does not fit Q
// and three stages of 128-key K and V tiles (48 + 288 KB), nor O (96 registers)
// beside the 128-key S: it takes 64-key tiles.  D = 256 takes 64-key tiles too,
// and a ring of two stages: Q (64 KB) and three stages (192 KB) would pass the
// 227 KB a block may have; O is 128 registers a thread beside S's 32.  Against
// D = 128 it gives up a third of the ring (one tile in flight while the other
// is computed) and half the keys per softmax step, and its P V is four N = 64
// products.
// f32 (flash_fwd, FMA on the CUDA cores; the tensor cores have no f32 product
//   without TF32 rounding): 8 warps, warp w owns query rows 8 w .. 8 w + 7;
//   for the scores a lane owns keys lane and lane + 32 of the tile, for the
//   output D / 32 neighbouring columns (D = 16: lanes 0..15, one column
//   each); row max and sum are butterfly shuffles over the warp; p goes
//   through shared memory.  Shared memory rows carry 16 bytes of padding, so
//   8 lanes reading 16 bytes each hit distinct banks.
//
// C interface (bound with ctypes): every pointer is a device pointer, the
// stream is the caller's current stream, nothing is allocated on the device
// here, and the entry point returns the launch's cudaError_t (0 = launched),
// or kEncodeError + the CUresult when a tensor map cannot be encoded (the
// maps are encoded and kept by hopper.cuh: a prefill encodes each tensor's
// map once).

#include <cmath>
#include <cstdint>
#include <type_traits>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attention_any.cuh"
#include "hopper.cuh"

namespace {

using hopper::fence_regs;
using hopper::gmma_desc;
using hopper::mbar_arrive;
using hopper::mbar_expect_tx;
using hopper::mbar_init;
using hopper::mbar_wait;
using hopper::smem_addr;
using hopper::tma_load_4d;
using hopper::wgmma_commit;
using hopper::wgmma_fence;
using hopper::wgmma_rs_n64;
using hopper::wgmma_wait;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 8;
constexpr int kBQ = kWarps * kRowsPerWarp;   // query rows per block (f32)
constexpr int kBK = 64;                      // keys per KV tile (f32)
constexpr float kMasked = -1e30f;

template <int kBytes>
struct Raw;
template <>
struct Raw<16> {
  using type = uint4;
};
template <>
struct Raw<8> {
  using type = uint2;
};
template <>
struct Raw<4> {
  using type = uint32_t;
};

// N floats at p (4 N bytes, aligned to that, or to 16 for N = 8) in one
// vector access (two for N = 8).
template <int N>
__device__ __forceinline__ void load_f(const float* p, float (&out)[N]) {
  constexpr int kW = N < 4 ? N : 4;
  using R = typename Raw<4 * kW>::type;
#pragma unroll
  for (int v = 0; v < N / kW; ++v) {
    const R raw = *reinterpret_cast<const R*>(p + v * kW);
    const float* e = reinterpret_cast<const float*>(&raw);
#pragma unroll
    for (int i = 0; i < kW; ++i) out[v * kW + i] = e[i];
  }
}

template <int N>
__device__ __forceinline__ void store_f(float* p, const float (&in)[N]) {
  constexpr int kW = N < 4 ? N : 4;
  using R = typename Raw<4 * kW>::type;
#pragma unroll
  for (int v = 0; v < N / kW; ++v) {
    R raw;
    float* e = reinterpret_cast<float*>(&raw);
#pragma unroll
    for (int i = 0; i < kW; ++i) e[i] = in[v * kW + i];
    *reinterpret_cast<R*>(p + v * kW) = raw;
  }
}

// Rows [row0, row0 + kRows) of one head of a [B, S, H, cols] tensor into
// shared memory as D columns with row pitch `ld` elements, as 16-byte
// vectors; rows at or past `rows` and columns at or past `cols` (the true
// head dim, a multiple of 8) are zero (a zero V row times p = 0 adds
// nothing, a zero column adds nothing to q k^T).
template <typename T, int D, int kRows, int kNThreads = kThreads>
__device__ __forceinline__ void load_tile(T* dst, int ld, const T* src,
                                          long long stride_s, int row0,
                                          int rows, int cols) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = D / kVec;
  for (int i = threadIdx.x; i < kRows * kPerRow; i += kNThreads) {
    const int r = i / kPerRow;
    const int c = (i - r * kPerRow) * kVec;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < rows && c < cols)
      v = *reinterpret_cast<const uint4*>(src + (row0 + r) * stride_s + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = v;
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The KV tiles of kTileK keys, [kt_begin, kt_end), that a q tile of rows
// [q0, q0 + rows) visits (see "Skipped tiles" above).
template <int kTileK = kBK>
__device__ __forceinline__ void kv_tiles(int q0, int rows, int Sq, int Skv,
                                         int causal, int has_window,
                                         int window, int& kt_begin,
                                         int& kt_end) {
  const int off = Skv - Sq;
  const int q_lo = q0 + off;
  const int q_hi = min(q0 + rows, Sq) - 1 + off;
  kt_begin = 0;
  kt_end = (Skv + kTileK - 1) / kTileK;
  if (causal && q_lo >= 0 && (!has_window || window >= 1)) {
    kt_end = min(kt_end, q_hi / kTileK + 1);
    if (has_window) kt_begin = max(0, (q_lo - window + 1) / kTileK);
  }
}

// Score of query position qpos against key kpos, scaled and masked as the
// reference masks (-1e30); a key past the sequence gets -inf, so p = 0.
__device__ __forceinline__ float masked_score(float dot, float scale,
                                              int qpos, int kpos, int Skv,
                                              int causal, int has_window,
                                              int window) {
  // selects, not branches: the tensor-core path masks 64 scores a thread
  const bool masked =
      (causal && kpos > qpos) || (has_window && kpos <= qpos - window);
  const float v = masked ? kMasked : dot * scale;
  return kpos >= Skv ? -INFINITY : v;
}

// ---------------------------------------------------------------------------
// f32 on the CUDA cores (FMA)
// ---------------------------------------------------------------------------

template <int D>
struct Smem {
  static constexpr int kVec = 4;
  static constexpr int kLd = D + kVec;        // padded row pitch (elements)
  static constexpr size_t kQ = size_t(kBQ) * kLd * sizeof(float);
  static constexpr size_t kK = size_t(kBK) * kLd * sizeof(float);
  static constexpr size_t kV = size_t(kBK) * D * sizeof(float);
  static constexpr size_t kP = size_t(kWarps) * kRowsPerWarp * kBK * sizeof(float);
  static constexpr size_t kBytes = kQ + kK + kV + kP;
};

// D: the instance's width; dt: the true head dim (dt <= D, a multiple of 8),
// the columns of q, k, v and out; shared memory holds zeros past it.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, float* __restrict__ out, int Sq,
          int Skv, int H, int rep, int dt, long long q_sb, long long q_ss,
          long long q_sh, long long k_sb, long long k_ss, long long k_sh,
          long long v_sb, long long v_ss, long long v_sh, int causal,
          int has_window, int window, float scale) {
  using T = float;
  using L = Smem<D>;
  constexpr int kVec = L::kVec;
  constexpr int kLd = L::kLd;
  // output columns per lane: D / 32 rounded up to a vector (lanes past D
  // own none: D 16 uses 16 lanes, D 80 20, D 112 28, D 192 24)
  constexpr int kCols = D <= 32 ? 1 : (D <= 64 ? 2 : (D <= 128 ? 4 : 8));
  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* Ks = reinterpret_cast<T*>(smem + L::kQ);
  T* Vs = reinterpret_cast<T*>(smem + L::kQ + L::kK);
  float* Ps = reinterpret_cast<float*>(smem + L::kQ + L::kK + L::kV);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int hk = h / rep;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;   // longest rows first
  const int off = Skv - Sq;

  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + hk * k_sh;
  const T* vb = v + b * v_sb + hk * v_sh;
  load_tile<T, D, kBQ>(Qs, kLd, qb, q_ss, q0, Sq, dt);

  int kt_begin, kt_end;
  kv_tiles(q0, kBQ, Sq, Skv, causal, has_window, window, kt_begin, kt_end);

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kCols];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = kMasked;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[r][j] = 0.f;
  }
  const int row_base = warp * kRowsPerWarp;
  float* Pw = Ps + warp * kRowsPerWarp * kBK;
  const bool col_lane = lane * kCols < D;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();                     // last tile's readers are done
    load_tile<T, D, kBK>(Ks, kLd, kb, k_ss, k0, Skv, dt);
    load_tile<T, D, kBK>(Vs, D, vb, v_ss, k0, Skv, dt);
    __syncthreads();

    // scores of this warp's 8 rows against keys lane and lane + 32
    float s[kRowsPerWarp][2];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r][0] = s[r][1] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; d += kVec) {
      float ka[kVec], kc[kVec];
      load_f<kVec>(Ks + lane * kLd + d, ka);
      load_f<kVec>(Ks + (lane + 32) * kLd + d, kc);
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        float qv[kVec];
        load_f<kVec>(Qs + (row_base + r) * kLd + d, qv);
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          s[r][0] = fmaf(qv[e], ka[e], s[r][0]);
          s[r][1] = fmaf(qv[e], kc[e], s[r][1]);
        }
      }
    }

    // mask, online softmax, p of this warp's rows into shared memory
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int qpos = q0 + row_base + r + off;
      float p2[2];
#pragma unroll
      for (int j = 0; j < 2; ++j)
        p2[j] = masked_score(s[r][j], scale, qpos, k0 + lane + 32 * j, Skv,
                             causal, has_window, window);
      const float m_new = fmaxf(m[r], warp_max(fmaxf(p2[0], p2[1])));
      p2[0] = expf(p2[0] - m_new);
      p2[1] = expf(p2[1] - m_new);
      const float alpha = expf(m[r] - m_new);
      l[r] = l[r] * alpha + warp_sum(p2[0] + p2[1]);
      m[r] = m_new;
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[r][j] *= alpha;
      Pw[r * kBK + lane] = p2[0];        // v is f32: p needs no rounding
      Pw[r * kBK + lane + 32] = p2[1];
    }
    __syncwarp();

    // acc += p @ v over this tile's keys
    if (col_lane) {
#pragma unroll 2
      for (int c = 0; c < kBK; c += 4) {
        float vv[4][kCols];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          load_f<kCols>(Vs + (c + u) * D + lane * kCols, vv[u]);
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          const float4 p4 = *reinterpret_cast<const float4*>(Pw + r * kBK + c);
          const float pr[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int j = 0; j < kCols; ++j)
              acc[r][j] = fmaf(pr[u], vv[u][j], acc[r][j]);
        }
      }
    }
    __syncwarp();
  }

  if (lane * kCols < dt) {             // the true columns only
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int row = q0 + row_base + r;
      if (row < Sq) {
        const float inv = 1.f / fmaxf(l[r], 1e-30f);
        float o[kCols];
#pragma unroll
        for (int j = 0; j < kCols; ++j) o[j] = acc[r][j] * inv;
        store_f<kCols>(
            out + ((static_cast<long long>(b) * Sq + row) * H + h) * dt +
                lane * kCols,
            o);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 on Hopper: TMA loads, wgmma, one producer and two consumer warpgroups
// ---------------------------------------------------------------------------

constexpr int kTQ = 128;                     // query rows per block
constexpr int kWgThreads = 128;
// two consumer warpgroups, one of whose threads also issues the loads: with
// 8 warps ptxas may give a thread up to 255 registers, which the pipelined
// consumers need (sc, o and p live at once); a ninth warp (a producer warp
// or warpgroup) puts three warps on one scheduler and caps every thread at
// 168, and setmaxnreg did not lift ptxas's cap: the wgmma were serialised
// for want of registers
constexpr int kHopperThreads = 2 * kWgThreads;

// 2^x by the special-function unit (relative error below 2^-22; -inf and
// arguments below -126 give 0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d[64] (+)= A * B, m64n128k16, A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a,
                                              uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d[32] (+)= A * B, m64n64k16, A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                             uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d[8] += A * B, m64n16k16, A from registers (the m16n8k16 A fragment
// of the thread's warp), B MN-major in shared memory (transpose bit set).
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}

// d[16] += A * B, m64n32k16, A from registers (the m16n8k16 A fragment
// of the thread's warp), B MN-major in shared memory (transpose bit set).
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}

// d[64] += A * B, m64n128k16, A from registers (the m16n8k16 A fragment
// of the thread's warp), B MN-major in shared memory (transpose bit set).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}


// Shared memory of a block and the tile shapes of an instance of width D.
// D = 112 is kept as 128 columns (kDp): TMA fills the 16 columns past it
// (and past any true head dim under it) with zeros, which add nothing to
// Q K^T, and which give zero output columns in P V that are not stored.
// D > 128 takes 64-key tiles (kTK), so that Q and the K/V ring fit (D 192:
// 48 + 144 KB in 3 stages; D 256: 64 + 128 KB in 2) and the accumulators
// (O 96 / 128, S 32 registers a thread) fit the register file; the others
// take 128-key tiles, the reference's own blocks.
// Layout: Q [kTQ x kDp], then kStages K tiles and kStages V tiles [kTK x
// kDp], then the mbarriers.  A tile is kDp / kChunk column boxes of its rows
// x kChunk elements (64, or 32 / 16 where kDp is no multiple of 64), each
// row one swizzle span (kRowBytes), so a box is the canonical swizzled
// layout wgmma reads: 8-row atoms of 8 * kRowBytes bytes, one after another.
template <int D>
struct HopperSmem {
  static constexpr int kDp = D == 112 ? 128 : D;
  static constexpr int kTK = D > 128 ? 64 : 128;
  static constexpr int kStages = D > 192 ? 2 : 3;     // K/V ring depth
  static constexpr int kChunk =
      kDp % 64 == 0 ? 64 : (kDp % 32 == 0 ? 32 : 16);
  static constexpr int kRowBytes = kChunk * 2;
  static constexpr int kChunks = kDp / kChunk;
  static constexpr int kQChunkBytes = kTQ * kRowBytes;
  static constexpr int kQBytes = kChunks * kQChunkBytes;
  static constexpr int kChunkBytes = kTK * kRowBytes;   // of a K / V tile
  static constexpr int kTileBytes = kChunks * kChunkBytes;
  static constexpr int kAtomBytes = 8 * kRowBytes;
  static constexpr uint64_t kLayout =
      kRowBytes == 128 ? 1 : (kRowBytes == 64 ? 2 : 3);
  static constexpr int kK = kQBytes;
  static constexpr int kV = kK + kStages * kTileBytes;
  static constexpr int kBar = kV + kStages * kTileBytes;
  static constexpr int kBars = 1 + 3 * kStages;      // q, full K / V, empty
  static constexpr size_t kBytes = 1024 + kBar + 8 * kBars;   // + alignment
  static_assert(kBytes <= 232448, "a block's shared memory");
};

// O += P V for one 16-key slice, N = kDp: one product, or (kDp 80, 96, 192,
// 256) one per column box of N = kChunk (an m64nkChunk accumulator's
// registers are the m64nkDp one's kChunk / 2 c .. kChunk / 2 (c + 1) - 1).
template <int D>
__device__ __forceinline__ void wgmma_pv(float (&d)[HopperSmem<D>::kDp / 2],
                                         const uint32_t (&a)[4], uint64_t b) {
  using L = HopperSmem<D>;
  constexpr int kN = L::kChunk;
  if constexpr (L::kDp == 16) {
    wgmma_rs_n16(d, a, b);
  } else if constexpr (L::kDp == 32) {
    wgmma_rs_n32(d, a, b);
  } else if constexpr (L::kDp == 64) {
    wgmma_rs_n64(d, a, b);
  } else if constexpr (L::kDp == 128) {
    wgmma_rs_n128(d, a, b);
  } else {
#pragma unroll
    for (int c = 0; c < L::kChunks; ++c) {
      float(&dc)[kN / 2] = *reinterpret_cast<float(*)[kN / 2]>(d + kN / 2 * c);
      const uint64_t bc = b + ((c * L::kChunkBytes) >> 4);
      if constexpr (kN == 64)
        wgmma_rs_n64(dc, a, bc);
      else if constexpr (kN == 32)
        wgmma_rs_n32(dc, a, bc);
      else
        wgmma_rs_n16(dc, a, bc);
    }
  }
}

// S = Q K^T of one tile, over D in steps of 16 (issued, not waited for).
// A step's descriptors are the tile's plus a constant: the start address
// field (address / 16, under 2^14 in shared memory) never carries.
template <int D>
__device__ __forceinline__ void issue_qk(float (&sc)[HopperSmem<D>::kTK / 2],
                                         uint32_t q_wg, uint32_t kst) {
  using L = HopperSmem<D>;
  const uint64_t qd = gmma_desc(q_wg, 16, L::kAtomBytes, L::kLayout);
  const uint64_t kd = gmma_desc(kst, 16, L::kAtomBytes, L::kLayout);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 / L::kChunk;
    const int in_row = (kk * 16 - c * L::kChunk) * 2;
    const uint64_t qs = (c * L::kQChunkBytes + in_row) >> 4;
    const uint64_t ks = (c * L::kChunkBytes + in_row) >> 4;
    if constexpr (L::kTK == 128)
      wgmma_ss_n128(sc, qd + qs, kd + ks, kk > 0);
    else
      wgmma_ss_n64(sc, qd + qs, kd + ks, kk > 0);
  }
  wgmma_commit();
}

// O += P V of one tile (issued, not waited for).
template <int D>
__device__ __forceinline__ void issue_pv(
    float (&o)[HopperSmem<D>::kDp / 2],
    const uint32_t (&pa)[HopperSmem<D>::kTK / 16][4], uint32_t vst) {
  using L = HopperSmem<D>;
  const uint64_t vd =
      gmma_desc(vst, L::kChunkBytes, L::kAtomBytes, L::kLayout);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < L::kTK / 16; ++kk)
    wgmma_pv<D>(o, pa[kk], vd + ((kk * 16 * L::kRowBytes) >> 4));
  wgmma_commit();
}

// The online softmax of one tile of kTile keys on its scores (base 2: the
// scale carries log2 e), masked only where the tile straddles a mask edge:
// leaves p in sc, updates m and this thread's part of l, and gives each
// row's alpha.  The thread's rows sit at positions qpos0 and qpos0 + 8, its
// keys at kpos0 + 8 n + {0, 1}.
template <int kTile>
__device__ __forceinline__ void softmax_tile(
    float (&sc)[kTile / 2], float (&m_r)[2], float (&l_r)[2],
    float (&alpha)[2], bool edge, float scale_log2, int qpos0, int kpos0,
    int Skv, int causal, int has_window, int window) {
  float sc_scale = scale_log2;
  if (edge) {
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sc[4 * n + e] = masked_score(sc[4 * n + e], scale_log2,
                                     qpos0 + 8 * (e >> 1),
                                     kpos0 + 8 * n + (e & 1), Skv, causal,
                                     has_window, window);
    sc_scale = 1.f;
  }
  // (max and sum in two interleaved chains per row: shorter dependences)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n)
      mx[n & 1] = fmaxf(mx[n & 1],
                        fmaxf(sc[4 * n + 2 * r], sc[4 * n + 2 * r + 1]));
    float m = fmaxf(mx[0], mx[1]);
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
    const float m_new = fmaxf(m_r[r], m * sc_scale);
    alpha[r] = fast_exp2(m_r[r] - m_new);
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = sc[4 * n + 2 * r + e];
        x = fast_exp2(fmaf(x, sc_scale, -m_new));
        sum[n & 1] += x;
      }
    l_r[r] = l_r[r] * alpha[r] + (sum[0] + sum[1]);
    m_r[r] = m_new;
  }
}

// O *= alpha; p rounded to bf16 (v's dtype) into P V's A fragments.
template <int kCols, int kTile>
__device__ __forceinline__ void rescale_and_pack(float (&o)[kCols / 2],
                                                 uint32_t (&pa)[kTile / 16][4],
                                                 const float (&sc)[kTile / 2],
                                                 const float (&alpha)[2]) {
#pragma unroll
  for (int j = 0; j < kCols / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[4 * j + e] *= alpha[e >> 1];
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      pa[kk][e] = pack_bf16(sc[8 * kk + 2 * e], sc[8 * kk + 2 * e + 1]);
}

// The tensors as the narrow copies read them: pointers, element strides
// (q's batch, sequence and head strides, then k's, then v's) and each
// tensor's piece width in elements (hopper::piece_elems).
struct Rows {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  long long st[9];
  int pq, pk, pv;
};

// kNarrow: the tiles are filled by the narrow copies from `rows` instead of
// by TMA (see "Head dims" above); the tensor maps are then unused.
template <int D, bool kNarrow>
__global__ void __launch_bounds__(kHopperThreads, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v,
                __nv_bfloat16* __restrict__ out, int Sq, int Skv, int H,
                int rep, int dt, int causal, int has_window, int window,
                float scale_log2, const Rows rows) {
  using L = HopperSmem<D>;
  constexpr int kTK = L::kTK;
  constexpr int kStages = L::kStages;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar_q = base + L::kBar;
  const auto full_k = [&](int s) { return bar_q + 8 * (1 + s); };
  const auto full_v = [&](int s) { return bar_q + 8 * (1 + kStages + s); };
  const auto empty = [&](int s) { return bar_q + 8 * (1 + 2 * kStages + s); };

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int hk = h / rep;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTQ;   // longest rows first
  int kt_begin, kt_end;
  kv_tiles<kTK>(q0, kTQ, Sq, Skv, causal, has_window, window, kt_begin,
                kt_end);

  // Thread 0 loads Q and the first kStages K/V tiles; after that, the last
  // warp to release a stage (counted in `released`) refills it at once,
  // so neither warpgroup waits for the other to issue a load.
  // Narrow copies: warpgroup 1 (its 128 threads) fills every tile, Q and
  // the first stages after the barriers are set up, then each stage as it
  // releases it, once warpgroup 0 has released it too (its empty barrier).
  // Warpgroup 1 is the second to issue its products in each step (the
  // ping-pong below), so it is as a rule the second to release a stage and
  // seldom waits there; its copies are issued while warpgroup 0's products
  // hold the tensor cores.  A producer warp would cap the consumers'
  // registers (see kHopperThreads).
  const int n_tiles = kt_end - kt_begin;
  __shared__ uint32_t released[kStages];
  // rows row0 .. row0 + kRows - 1 of head hx of one tensor into a tile of
  // kRows rows (Q's kTQ or a stage's kTK; zeros past S and past dt)
  const auto copy_rows = [&](auto rows_c, uint32_t dst,
                             const __nv_bfloat16* p, long long sb,
                             long long ss, long long sh, int S, int hx,
                             int row0, int piece) {
    constexpr int kRows = decltype(rows_c)::value;
    const __nv_bfloat16* head = p + b * sb + hx * sh;
    hopper::copy_tile_w<kRows, L::kDp, L::kChunk>(
        piece, dst, kRows, dt,
        [&](int r) {
          return row0 + r < S ? head + (row0 + r) * ss : nullptr;
        },
        static_cast<int>(threadIdx.x) - kWgThreads, kWgThreads);
  };
  using QRows = std::integral_constant<int, kTQ>;
  using KRows = std::integral_constant<int, kTK>;
  const auto load_kv = [&](int i) {
    const int s = i % kStages;
    const int k0 = (kt_begin + i) * kTK;
    const uint32_t dk = base + L::kK + s * L::kTileBytes;
    const uint32_t dv = base + L::kV + s * L::kTileBytes;
    if constexpr (kNarrow) {
      copy_rows(KRows{}, dk, rows.k, rows.st[3], rows.st[4], rows.st[5], Skv,
                hk, k0, rows.pk);
      hopper::copies_arrive(full_k(s));
      copy_rows(KRows{}, dv, rows.v, rows.st[6], rows.st[7], rows.st[8], Skv,
                hk, k0, rows.pv);
      hopper::copies_arrive(full_v(s));
      return;
    }
    mbar_expect_tx(full_k(s), L::kTileBytes);
#pragma unroll
    for (int c = 0; c < L::kChunks; ++c)
      tma_load_4d(dk + c * L::kChunkBytes, &tm_k, full_k(s), c * L::kChunk,
                  hk, k0, b);
    mbar_expect_tx(full_v(s), L::kTileBytes);
#pragma unroll
    for (int c = 0; c < L::kChunks; ++c)
      tma_load_4d(dv + c * L::kChunkBytes, &tm_v, full_v(s), c * L::kChunk,
                  hk, k0, b);
  };
  // tile i is done with by this warp: its stage is released, and refilled
  // with tile i + kStages by the last warp
  const auto release = [&](int i) {
    const int s = i % kStages;
    if constexpr (kNarrow) {
      if ((threadIdx.x & 31) == 0) mbar_arrive(empty(s));
      if (threadIdx.x >= kWgThreads && i + kStages < n_tiles) {
        mbar_wait(empty(s), (i / kStages) & 1);
        load_kv(i + kStages);
      }
      __syncwarp();
      return;
    }
    if ((threadIdx.x & 31) == 0) {
      mbar_arrive(empty(s));
      if (i + kStages < n_tiles &&
          atomicAdd(&released[s], 1u) % (kHopperThreads / 32) ==
              kHopperThreads / 32 - 1) {
        mbar_wait(empty(s), (i / kStages) & 1);
        load_kv(i + kStages);
      }
    }
    __syncwarp();
  };
  if (threadIdx.x == 0) {
    // a full barrier completes on TMA's bytes, or on two arrivals from
    // each of warpgroup 1's threads (hopper::copies_arrive)
    const int arrivals = kNarrow ? 2 * kWgThreads : 1;
    mbar_init(bar_q, arrivals);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k(s), arrivals);
      mbar_init(full_v(s), arrivals);
      mbar_init(empty(s), kHopperThreads / 32);   // every warp
    }
    for (int s = 0; s < kStages; ++s) released[s] = 0;
    hopper::mbar_init_fence();
    if constexpr (!kNarrow) {
      mbar_expect_tx(bar_q, L::kQBytes);
#pragma unroll
      for (int c = 0; c < L::kChunks; ++c)
        tma_load_4d(base + c * L::kQChunkBytes, &tm_q, bar_q, c * L::kChunk,
                    h, q0, b);
      for (int i = 0; i < min(n_tiles, kStages); ++i) load_kv(i);
    }
  }
  __syncthreads();
  if constexpr (kNarrow) {
    if (threadIdx.x >= kWgThreads) {
      copy_rows(QRows{}, base, rows.q, rows.st[0], rows.st[1], rows.st[2], Sq,
                h, q0, rows.pq);
      hopper::copies_arrive(bar_q);
      for (int i = 0; i < min(n_tiles, kStages); ++i) load_kv(i);
    }
  }

  {
    // warpgroup cw owns query rows 64 cw .. 64 cw + 63; in it, lane t of
    // warp w holds rows 16 w + t / 4 (r = 0) and + 8 (r = 1) of every
    // accumulator, columns 8 n + 2 (t % 4) + {0, 1}
    const int cw = threadIdx.x / kWgThreads;
    const int t = threadIdx.x % kWgThreads;
    const int lane = t & 31;
    const int tq = lane & 3;
    const int row0 = cw * 64 + (t >> 5) * 16 + (lane >> 2);
    const int off = Skv - Sq;
    const int qpos0 = q0 + row0 + off;
    const int qlo = q0 + cw * 64 + off;        // the warpgroup's positions
    const int qhi = qlo + 63;
    const uint32_t q_wg = base + cw * 64 * L::kRowBytes;

    float o[L::kDp / 2];
#pragma unroll
    for (int j = 0; j < L::kDp / 2; ++j) o[j] = 0.f;
    float m_r[2] = {kMasked, kMasked};
    float l_r[2] = {0.f, 0.f};                 // this thread's part of l
    float sc[kTK / 2];                         // S, then p, of one tile
    uint32_t pa[kTK / 16][4];                  // p in bf16: P V's A operand
    float alpha[2];

    // Software pipeline: step j issues S = Q K^T of tile j, then O += P V
    // of tile j - 1, and runs tile j's softmax while the tensor cores still
    // multiply tile j - 1's P by V.  A q tile visits at least one KV tile
    // (its first row sees its own key, or nothing is skipped).
    const auto edge = [&](int j) {
      const int k0 = (kt_begin + j) * kTK;
      return k0 + kTK > Skv || (causal && k0 + kTK - 1 > qlo) ||
             (has_window && k0 <= qhi - window);
    };
    const auto kpos0 = [&](int j) { return (kt_begin + j) * kTK + 2 * tq; };
    // ping-pong: warpgroup cw issues products only in its turn (barrier
    // 1 + cw) and then passes the turn on; warpgroup 0 has the first, and
    // warpgroup 1 does not pass its last
    const auto turn_take = [&] {
      hopper::named_barrier_sync(1 + cw, 2 * kWgThreads);
    };
    const auto turn_pass = [&] {
      hopper::named_barrier_arrive(2 - cw, 2 * kWgThreads);
    };
    if (cw == 1) turn_pass();
    mbar_wait(bar_q, 0);
    mbar_wait(full_k(0), 0);
    if constexpr (kNarrow) hopper::fence_proxy_async();   // the copies
    turn_take();
    issue_qk<D>(sc, q_wg, base + L::kK);
    turn_pass();
    wgmma_wait<0>();
    fence_regs(sc);
    softmax_tile<kTK>(sc, m_r, l_r, alpha, edge(0), scale_log2, qpos0,
                      kpos0(0), Skv, causal, has_window, window);
    rescale_and_pack<L::kDp, kTK>(o, pa, sc, alpha);
    for (int j = 1; j < n_tiles; ++j) {
      const int s = j % kStages;
      const int sp = (j - 1) % kStages;
      mbar_wait(full_k(s), (j / kStages) & 1);
      mbar_wait(full_v(sp), ((j - 1) / kStages) & 1);
      if constexpr (kNarrow) hopper::fence_proxy_async();
      turn_take();
      issue_qk<D>(sc, q_wg, base + L::kK + s * L::kTileBytes);
      issue_pv<D>(o, pa, base + L::kV + sp * L::kTileBytes);
      turn_pass();
      wgmma_wait<1>();                           // S is in; P V runs on
      fence_regs(sc);
      softmax_tile<kTK>(sc, m_r, l_r, alpha, edge(j), scale_log2, qpos0,
                        kpos0(j), Skv, causal, has_window, window);
      wgmma_wait<0>();                           // P V of tile j - 1 is done
      fence_regs(o);
      fence_regs(pa);
      release(j - 1);
      rescale_and_pack<L::kDp, kTK>(o, pa, sc, alpha);
    }
    {
      const int sp = (n_tiles - 1) % kStages;
      mbar_wait(full_v(sp), ((n_tiles - 1) / kStages) & 1);
      if constexpr (kNarrow) hopper::fence_proxy_async();
      turn_take();
      issue_pv<D>(o, pa, base + L::kV + sp * L::kTileBytes);
      if (cw == 0) turn_pass();
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(pa);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_r[r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const int row = q0 + row0 + 8 * r;
      if (row < Sq) {
        const float inv = 1.f / fmaxf(l, 1e-30f);
        __nv_bfloat16* dst =
            out + ((static_cast<long long>(b) * Sq + row) * H + h) * dt + 2 * tq;
#pragma unroll
        for (int j = 0; j < L::kDp / 8; ++j) {
          const float o0 = o[4 * j + 2 * r] * inv;
          const float o1 = o[4 * j + 2 * r + 1] * inv;
          if constexpr (kNarrow) {
            // any dt: element by element (a pair may straddle dt, or sit
            // at an odd address)
            if (8 * j + 2 * tq < dt) dst[8 * j] = __float2bfloat16(o0);
            if (8 * j + 2 * tq + 1 < dt) dst[8 * j + 1] = __float2bfloat16(o1);
          } else if (8 * j < dt) {               // the true columns only
            *reinterpret_cast<uint32_t*>(dst + 8 * j) = pack_bf16(o0, o1);
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 past D 256 on wgmma: output slices, Q K^T streamed in 64 columns
// ---------------------------------------------------------------------------

constexpr int kWideSlice = 128;      // output columns of a block
constexpr int kWidePiece = 64;       // columns of Q and K per product step
constexpr int kWideUnit = 32768;     // a Q and a K piece, or a V slice
constexpr int kWideUnits = 4;        // the ring: three units in flight
constexpr int kWideBytes = 1024 + kWideUnits * kWideUnit;

// O[:, col0 .. col0 + 127] of 128 query rows of one (batch row, q head),
// col0 = 128 blockIdx.z: for each 128-key tile (the skipped ones skipped),
// S = Q K^T over the whole D as ceil(D / 64) steps of Q's and K's next 64
// columns (m64n128k16, A and B K-major), the online softmax on S
// (softmax_tile, the TMA instances' code: p rounded at each 128-key
// tile's running max, as the reference rounds it), then O += P V of V's
// 128 columns (the D 128 instance's P V).  Each warpgroup owns 64 rows.
// The loads are a sequence of 32 KB units (a Q and a K piece; a V slice)
// through a ring of kWideUnits, copied by all 256 threads with the narrow
// copies (cp.async groups, kWideUnits - 1 units ahead) and handed over by
// one block barrier a unit.  The registers: S 64, O 64 and P 32 a thread,
// so O takes 128 columns, not 256 (with S and P beside 128 registers of O
// they would pass the 255 a thread may hold).
__global__ void __launch_bounds__(kHopperThreads, 1)
flash_fwd_wide(__nv_bfloat16* __restrict__ out, int Sq, int Skv, int H,
               int rep, int dt, int causal, int has_window, int window,
               float scale_log2, const Rows rows) {
  using L = HopperSmem<128>;          // P V's tiles: 128 keys x 128 columns
  constexpr int kTK = 128;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int hk = h / rep;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTQ;   // longest rows first
  const int col0 = blockIdx.z * kWideSlice;
  int kt_begin, kt_end;
  kv_tiles<kTK>(q0, kTQ, Sq, Skv, causal, has_window, window, kt_begin,
                kt_end);
  const int n_tiles = kt_end - kt_begin;
  const int pieces = (dt + kWidePiece - 1) / kWidePiece;
  const int per_tile = pieces + 1;                     // + the V slice
  const int units = n_tiles * per_tile;
  const __nv_bfloat16* qh = rows.q + b * rows.st[0] + h * rows.st[2];
  const __nv_bfloat16* kh = rows.k + b * rows.st[3] + hk * rows.st[5];
  const __nv_bfloat16* vh = rows.v + b * rows.st[6] + hk * rows.st[8];
  const auto unit_at = [&](int u) { return base + (u % kWideUnits) * kWideUnit; };

  // unit u into its ring slot (an empty group past the last: every thread
  // commits one group a unit, so a wait's count is the same everywhere)
  const auto issue = [&](int u) {
    if (u < units) {
      const int j = u / per_tile;
      const int part = u - j * per_tile;
      const int k0 = (kt_begin + j) * kTK;
      const uint32_t dst = unit_at(u);
      const int tid = threadIdx.x;
      if (part < pieces) {
        const int c0 = part * kWidePiece;
        hopper::copy_tile_w<kTQ, kWidePiece, kWidePiece>(
            rows.pq, dst, kTQ, dt - c0,
            [&](int r) {
              return q0 + r < Sq ? qh + (q0 + r) * rows.st[1] + c0 : nullptr;
            },
            tid, kHopperThreads);
        hopper::copy_tile_w<kTK, kWidePiece, kWidePiece>(
            rows.pk, dst + kTQ * 128, kTK, dt - c0,
            [&](int r) {
              return k0 + r < Skv ? kh + (k0 + r) * rows.st[4] + c0 : nullptr;
            },
            tid, kHopperThreads);
      } else {
        hopper::copy_tile_w<kTK, kWideSlice, L::kChunk>(
            rows.pv, dst, kTK, dt - col0,
            [&](int r) {
              return k0 + r < Skv ? vh + (k0 + r) * rows.st[7] + col0
                                  : nullptr;
            },
            tid, kHopperThreads);
      }
    }
    hopper::cp_async_commit();
  };

  const int cw = threadIdx.x / kWgThreads;
  const int t = threadIdx.x % kWgThreads;
  const int lane = t & 31;
  const int tq = lane & 3;
  const int row0 = cw * 64 + (t >> 5) * 16 + (lane >> 2);
  const int off = Skv - Sq;
  const int qpos0 = q0 + row0 + off;
  const int qlo = q0 + cw * 64 + off;
  const int qhi = qlo + 63;
  float o[kWideSlice / 2];
#pragma unroll
  for (int i = 0; i < kWideSlice / 2; ++i) o[i] = 0.f;
  float m_r[2] = {kMasked, kMasked};
  float l_r[2] = {0.f, 0.f};
  float sc[kTK / 2];
  uint32_t pa[kTK / 16][4];
  float alpha[2];

  for (int u = 0; u < kWideUnits - 1; ++u) issue(u);
  for (int u = 0; u < units; ++u) {
    // unit u is in (this thread's copies, then everyone's), and every
    // warpgroup is done with unit u - 1, whose slot the next issue fills
    hopper::cp_async_wait<kWideUnits - 2>();
    hopper::fence_proxy_async();
    __syncthreads();
    issue(u + kWideUnits - 1);
    const int j = u / per_tile;
    const int part = u - j * per_tile;
    const uint32_t src = unit_at(u);
    if (part < pieces) {
      // S (+)= Q[:, c0 .. c0 + 63] K[:, c0 .. c0 + 63]^T
      const uint64_t qd =
          gmma_desc(src + cw * 64 * 128, 16, 1024, 1);
      const uint64_t kd = gmma_desc(src + kTQ * 128, 16, 1024, 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kWidePiece / 16; ++kk)
        wgmma_ss_n128(sc, qd + 2 * kk, kd + 2 * kk, part > 0 || kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      if (part == pieces - 1) {
        const int k0 = (kt_begin + j) * kTK;
        const bool edge = k0 + kTK > Skv || (causal && k0 + kTK - 1 > qlo) ||
                          (has_window && k0 <= qhi - window);
        softmax_tile<kTK>(sc, m_r, l_r, alpha, edge, scale_log2, qpos0,
                          k0 + 2 * tq, Skv, causal, has_window, window);
        rescale_and_pack<kWideSlice, kTK>(o, pa, sc, alpha);
      }
    } else {
      issue_pv<128>(o, pa, src);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(pa);
    }
  }
  hopper::cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_r[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = q0 + row0 + 8 * r;
    if (row < Sq) {
      const float inv = 1.f / fmaxf(l, 1e-30f);
      __nv_bfloat16* dst = out +
                           ((static_cast<long long>(b) * Sq + row) * H + h) * dt +
                           col0 + 2 * tq;
#pragma unroll
      for (int j = 0; j < kWideSlice / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (col0 + 8 * j + 2 * tq + e < dt)
            dst[8 * j + e] = __float2bfloat16(o[4 * j + 2 * r + e] * inv);
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// The tensors' rows as the narrow copies read them.
inline Rows narrow_rows(const void* q, const void* k, const void* v, int dt,
                        const long long* st) {
  Rows r{static_cast<const __nv_bfloat16*>(q),
         static_cast<const __nv_bfloat16*>(k),
         static_cast<const __nv_bfloat16*>(v), {}, 0, 0, 0};
  for (int i = 0; i < 9; ++i) r.st[i] = st[i];
  r.pq = hopper::piece_elems(q, dt, st, 3);
  r.pk = hopper::piece_elems(k, dt, st + 3, 3);
  r.pv = hopper::piece_elems(v, dt, st + 6, 3);
  return r;
}

// D: the instance's width; dt: the true head dim, the tensors' columns.
// kNarrow: the tiles come by the narrow copies (no tensor maps).
template <int D, bool kNarrow>
int launch_wgmma(const void* q, const void* k, const void* v, void* out,
                 int B, int Sq, int Skv, int H, int Hkv, int dt,
                 const long long* st, int causal, int has_window, int window,
                 float scale, cudaStream_t stream) {
  using L = HopperSmem<D>;
  // boxes of kTQ (q) or kTK (k, v) rows x kChunk elements, one swizzle span
  // per row; the maps have dt columns, the boxes cover kDp
  const CUtensorMapSwizzle swizzle =
      L::kRowBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                          : (L::kRowBytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                : CU_TENSOR_MAP_SWIZZLE_32B);
  const auto map = [&](CUtensorMap* m, const void* p, int S, int Hx,
                       const long long* s3, int box_s) {
    return hopper::tensor_map(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, p, B, S,
                              Hx, dt, s3[0], s3[1], s3[2], L::kChunk, box_s,
                              swizzle);
  };
  CUtensorMap mq = {}, mk = {}, mv = {};
  Rows rows = {};
  if constexpr (kNarrow) {
    rows = narrow_rows(q, k, v, dt, st);
  } else {
    int rc = map(&mq, q, Sq, H, st, kTQ);
    if (rc == 0) rc = map(&mk, k, Skv, Hkv, st + 3, L::kTK);
    if (rc == 0) rc = map(&mv, v, Skv, Hkv, st + 6, L::kTK);
    if (rc) return rc;
  }
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_wgmma<D, kNarrow>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L::kBytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(B * H, (Sq + kTQ - 1) / kTQ);
  flash_fwd_wgmma<D, kNarrow><<<grid, kHopperThreads, L::kBytes, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(out), Sq, Skv, H, H / Hkv, dt,
      causal, has_window, window, scale * 1.4426950408889634f, rows);
  return static_cast<int>(cudaGetLastError());
}

// bf16 past D 256: flash_fwd_wide, one block per (batch row x q head, 128
// query rows, 128 output columns).
int launch_wide(const void* q, const void* k, const void* v, void* out, int B,
                int Sq, int Skv, int H, int Hkv, int dt, const long long* st,
                int causal, int has_window, int window, float scale,
                cudaStream_t stream) {
  static const cudaError_t ready = cudaFuncSetAttribute(
      flash_fwd_wide, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kWideBytes);
  if (ready != cudaSuccess) return static_cast<int>(ready);
  const dim3 grid(B * H, (Sq + kTQ - 1) / kTQ,
                  (dt + kWideSlice - 1) / kWideSlice);
  flash_fwd_wide<<<grid, kHopperThreads, kWideBytes, stream>>>(
      static_cast<__nv_bfloat16*>(out), Sq, Skv, H, H / Hkv, dt, causal,
      has_window, window, scale * 1.4426950408889634f,
      narrow_rows(q, k, v, dt, st));
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* out, int B,
               int Sq, int Skv, int H, int Hkv, int dt, const long long* st,
               int causal, int has_window, int window, float scale,
               cudaStream_t stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Smem<D>::kBytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((Sq + kBQ - 1) / kBQ, B * H);
  flash_fwd<D><<<grid, kThreads, Smem<D>::kBytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), Sq, Skv, H,
      H / Hkv, dt, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], causal, has_window, window, scale);
  return static_cast<int>(cudaGetLastError());
}

// The instance of width D: f32 on FMA (TMA loads), bf16 on wgmma with TMA
// loads or (narrow) the narrow copies.
template <int D>
int launch(int dtype, bool narrow, const void* q, const void* k,
           const void* v, void* out, int B, int Sq, int Skv, int H, int Hkv,
           int dt, const long long* st, int causal, int has_window,
           int window, float scale, cudaStream_t stream) {
  if (dtype == 0)
    return launch_f32<D>(q, k, v, out, B, Sq, Skv, H, Hkv, dt, st, causal,
                         has_window, window, scale, stream);
  if (narrow)
    return launch_wgmma<D, true>(q, k, v, out, B, Sq, Skv, H, Hkv, dt, st,
                                 causal, has_window, window, scale, stream);
  return launch_wgmma<D, false>(q, k, v, out, B, Sq, Skv, H, Hkv, dt, st,
                                causal, has_window, window, scale, stream);
}

// f32 at any other head dim or stride: the CUDA-core instance
// (attention_any.cuh).
int launch_any(const void* q, const void* k, const void* v, void* out, int B,
               int Sq, int Skv, int H, int Hkv, int D, const long long* st,
               int causal, int has_window, int window, float scale,
               cudaStream_t stream) {
  const attn_any::Args<float> a{
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), nullptr, B, Sq,
      Skv, H, Hkv, D, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], causal, has_window, window, scale};
  return attn_any::launch<float, false>(a, stream);
}

// The instance a call takes (see flash_attention_fwd): 0 the TMA instances,
// 1 the wgmma kernel with narrow copies, 2 the wide instance, 3 the
// CUDA-core instance; -1 for arguments the entry point refuses.
int route_of(int dtype, const void* q, const void* k, const void* v, int D,
             const long long* strides) {
  if ((dtype != 0 && dtype != 1) || D < 1) return -1;
  const void* ptrs[3] = {q, k, v};
  if (attn_any::aligned_rows(dtype == 0 ? 4 : 2, ptrs, 3, strides, 9) &&
      hopper::attention_width(D) != 0)
    return 0;
  if (dtype == 0) return 3;
  return D > 256 ? 2 : 1;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q [B, Sq, H, D], k/v [B, Skv, Hkv, D],
// each with unit stride over D and the (batch, sequence, head) strides in
// `strides` (q's three, then k's, then v's, in elements); out is a
// contiguous [B, Sq, H, D].  Any D >= 1; H a multiple of Hkv; `scale` is
// 1/sqrt(D).  bf16: D up to 256 in the wgmma instance of the smallest
// width that holds D rounded up to 8 (hopper::attention_width), by TMA
// where D is a multiple of 8 and the pointers and strides 16-byte aligned
// (every served shape), else by the narrow copies; D past 256 in
// flash_fwd_wide.  f32: D a multiple of 8 up to 256 with 16-byte aligned
// rows in the FMA instances (TMA loads), any other shape in the CUDA-core
// instance of attention_any.cuh.
extern "C" int flash_attention_fwd(int dtype, const void* q, const void* k,
                                   const void* v, void* out, int B, int Sq,
                                   int Skv, int H, int Hkv, int D,
                                   const long long* strides, int causal,
                                   int has_window, int window, float scale,
                                   void* stream) {
  if (Sq <= 0 || Skv <= 0 || B <= 0) return 0;
  const int route = route_of(dtype, q, k, v, D, strides);
  if (route < 0 || Hkv < 1 || H % Hkv)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  if (route == 3)
    return launch_any(q, k, v, out, B, Sq, Skv, H, Hkv, D, strides, causal,
                      has_window, window, scale, s);
  if (route == 2)
    return launch_wide(q, k, v, out, B, Sq, Skv, H, Hkv, D, strides, causal,
                       has_window, window, scale, s);
  const bool tma = route == 0;
#define REPRO_FLASH_WIDTH(W)                                                \
  case W:                                                                   \
    return launch<W>(dtype, !tma, q, k, v, out, B, Sq, Skv, H, Hkv, D,      \
                     strides, causal, has_window, window, scale, s);
  switch (hopper::attention_width((D + 7) / 8 * 8)) {
    REPRO_FLASH_WIDTH(16)
    REPRO_FLASH_WIDTH(32)
    REPRO_FLASH_WIDTH(64)
    REPRO_FLASH_WIDTH(80)
    REPRO_FLASH_WIDTH(96)
    REPRO_FLASH_WIDTH(112)
    REPRO_FLASH_WIDTH(128)
    REPRO_FLASH_WIDTH(192)
    REPRO_FLASH_WIDTH(256)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_FLASH_WIDTH
}

// Which instance flash_attention_fwd would run for these tensors (the
// route_of codes); tests hold the wrapper's ``route`` to it.
extern "C" int flash_attention_route(int dtype, const void* q, const void* k,
                                     const void* v, int D,
                                     const long long* strides) {
  return route_of(dtype, q, k, v, D, strides);
}

extern "C" const char* flash_attention_error_string(int code) {
  return hopper::error_string(code);
}
