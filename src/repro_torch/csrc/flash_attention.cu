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
//   The longest q tiles are launched first.  Every D in {16, 32, 64, 112,
//   128, 192} takes this path: a row of D = 16 / 32 fills a 32 / 64-byte
//   swizzle, and D = 128 is two 64-element column boxes per tile, D = 192
//   three.  D = 112 is 7 x 16, which wgmma takes, but its 224-byte rows fill
//   no swizzle span: its tiles are D = 128's, the second column box reaching
//   past the tensor maps' 112 columns, where TMA writes zeros.  D = 192 does
//   not fit Q and three stages of 128-key K and V tiles (48 + 288 KB), nor
//   O (96 registers) beside the 128-key S: it takes 64-key tiles.
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

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

// Rows [row0, row0 + kRows) of one head of a [B, S, H, D] tensor into shared
// memory with row pitch `ld` elements, as 16-byte vectors; rows at or past
// `rows` are zero (a zero V row times p = 0 adds nothing).
template <typename T, int D, int kRows, int kNThreads = kThreads>
__device__ __forceinline__ void load_tile(T* dst, int ld, const T* src,
                                          long long stride_s, int row0,
                                          int rows) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = D / kVec;
  for (int i = threadIdx.x; i < kRows * kPerRow; i += kNThreads) {
    const int r = i / kPerRow;
    const int c = (i - r * kPerRow) * kVec;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < rows)
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

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, float* __restrict__ out, int Sq,
          int Skv, int H, int rep, long long q_sb, long long q_ss,
          long long q_sh, long long k_sb, long long k_ss, long long k_sh,
          long long v_sb, long long v_ss, long long v_sh, int causal,
          int has_window, int window, float scale) {
  using T = float;
  using L = Smem<D>;
  constexpr int kVec = L::kVec;
  constexpr int kLd = L::kLd;
  // output columns per lane: D / 32 rounded up to a vector (lanes past D
  // own none: D 16 uses 16 lanes, D 112 28, D 192 24)
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
  load_tile<T, D, kBQ>(Qs, kLd, qb, q_ss, q0, Sq);

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
    load_tile<T, D, kBK>(Ks, kLd, kb, k_ss, k0, Skv);
    load_tile<T, D, kBK>(Vs, D, vb, v_ss, k0, Skv);
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

  if (col_lane) {
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int row = q0 + row_base + r;
      if (row < Sq) {
        const float inv = 1.f / fmaxf(l[r], 1e-30f);
        float o[kCols];
#pragma unroll
        for (int j = 0; j < kCols; ++j) o[j] = acc[r][j] * inv;
        store_f<kCols>(
            out + ((static_cast<long long>(b) * Sq + row) * H + h) * D +
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
constexpr int kStages = 3;                   // K/V ring depth
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


// Shared memory of a block and the tile shapes of head dim D.  D = 112 is
// kept as 128 columns (kDp): its tensor maps have D 112, and TMA fills the
// 16 columns past it with zeros, which add nothing to Q K^T, and which give
// zero output columns in P V that are not stored.  D = 192 takes 64-key
// tiles (kTK), so that Q and a 3-stage K/V ring fit (48 + 144 KB) and the
// accumulators (O 96, S 32 registers a thread) fit the register file; the
// others take 128-key tiles, the reference's own blocks.
// Layout: Q [kTQ x kDp], then kStages K tiles and kStages V tiles [kTK x
// kDp], then the mbarriers.  A tile is kDp / kChunk column boxes of its rows
// x kChunk elements, each row one swizzle span (kRowBytes), so a box is the
// canonical swizzled layout wgmma reads: 8-row atoms of 8 * kRowBytes bytes,
// one after another.
template <int D>
struct HopperSmem {
  static constexpr int kDp = D == 112 ? 128 : D;
  static constexpr int kTK = D > 128 ? 64 : 128;
  static constexpr int kChunk = kDp < 64 ? kDp : 64;
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
};

// O += P V for one 16-key slice, N = kDp: one product, or for kDp = 192
// three of N = 64, one per column box (an m64n64 accumulator's registers
// are the m64n192 one's 32 c .. 32 c + 31).
template <int D>
__device__ __forceinline__ void wgmma_pv(float (&d)[HopperSmem<D>::kDp / 2],
                                         const uint32_t (&a)[4], uint64_t b) {
  using L = HopperSmem<D>;
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
    for (int c = 0; c < L::kChunks; ++c)
      wgmma_rs_n64(*reinterpret_cast<float(*)[32]>(d + 32 * c), a,
                   b + ((c * L::kChunkBytes) >> 4));
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

template <int D>
__global__ void __launch_bounds__(kHopperThreads, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v,
                __nv_bfloat16* __restrict__ out, int Sq, int Skv, int H,
                int rep, int causal, int has_window, int window,
                float scale_log2) {
  using L = HopperSmem<D>;
  constexpr int kTK = L::kTK;
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
  const int n_tiles = kt_end - kt_begin;
  __shared__ uint32_t released[kStages];
  const auto load_kv = [&](int i) {
    const int s = i % kStages;
    const int k0 = (kt_begin + i) * kTK;
    const uint32_t dk = base + L::kK + s * L::kTileBytes;
    const uint32_t dv = base + L::kV + s * L::kTileBytes;
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
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty(s), kHopperThreads / 32);   // every warp
    }
    for (int s = 0; s < kStages; ++s) released[s] = 0;
    hopper::mbar_init_fence();
    mbar_expect_tx(bar_q, L::kQBytes);
#pragma unroll
    for (int c = 0; c < L::kChunks; ++c)
      tma_load_4d(base + c * L::kQChunkBytes, &tm_q, bar_q, c * L::kChunk, h,
                  q0, b);
    for (int i = 0; i < min(n_tiles, kStages); ++i) load_kv(i);
  }
  __syncthreads();

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
            out + ((static_cast<long long>(b) * Sq + row) * H + h) * D + 2 * tq;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)          // D, not kDp: the real columns
          *reinterpret_cast<uint32_t*>(dst + 8 * j) =
              pack_bf16(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* out,
                 int B, int Sq, int Skv, int H, int Hkv, const long long* st,
                 int causal, int has_window, int window, float scale,
                 cudaStream_t stream) {
  using L = HopperSmem<D>;
  // boxes of kTQ (q) or kTK (k, v) rows x kChunk elements, one swizzle span
  // per row; the maps have D columns, the boxes cover kDp
  const CUtensorMapSwizzle swizzle =
      L::kRowBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                          : (L::kRowBytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                : CU_TENSOR_MAP_SWIZZLE_32B);
  const auto map = [&](CUtensorMap* m, const void* p, int S, int Hx,
                       const long long* s3, int box_s) {
    return hopper::tensor_map(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, p, B, S,
                              Hx, D, s3[0], s3[1], s3[2], L::kChunk, box_s,
                              swizzle);
  };
  CUtensorMap mq, mk, mv;
  int rc = map(&mq, q, Sq, H, st, kTQ);
  if (rc == 0) rc = map(&mk, k, Skv, Hkv, st + 3, L::kTK);
  if (rc == 0) rc = map(&mv, v, Skv, Hkv, st + 6, L::kTK);
  if (rc) return rc;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L::kBytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(B * H, (Sq + kTQ - 1) / kTQ);
  flash_fwd_wgmma<D><<<grid, kHopperThreads, L::kBytes, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(out), Sq, Skv, H, H / Hkv,
      causal, has_window, window, scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* out, int B,
               int Sq, int Skv, int H, int Hkv, const long long* st,
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
      H / Hkv, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      causal, has_window, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(int dtype, const void* q, const void* k, const void* v, void* out,
           int B, int Sq, int Skv, int H, int Hkv, const long long* st,
           int causal, int has_window, int window, float scale,
           cudaStream_t stream) {
  if (dtype == 0)
    return launch_f32<D>(q, k, v, out, B, Sq, Skv, H, Hkv, st, causal,
                         has_window, window, scale, stream);
  return launch_wgmma<D>(q, k, v, out, B, Sq, Skv, H, Hkv, st, causal,
                         has_window, window, scale, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q [B, Sq, H, D], k/v [B, Skv, Hkv, D],
// each with unit stride over D and the (batch, sequence, head) strides in
// `strides` (q's three, then k's, then v's, in elements; 16-byte multiples);
// out is a contiguous [B, Sq, H, D].  D in {16, 32, 64, 112, 128, 192}; H a
// multiple of Hkv.
extern "C" int flash_attention_fwd(int dtype, const void* q, const void* k,
                                   const void* v, void* out, int B, int Sq,
                                   int Skv, int H, int Hkv, int D,
                                   const long long* strides, int causal,
                                   int has_window, int window, float scale,
                                   void* stream) {
  if (Sq <= 0 || Skv <= 0 || B <= 0) return 0;
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return launch<16>(dtype, q, k, v, out, B, Sq, Skv, H, Hkv, strides,
                        causal, has_window, window, scale, s);
    case 32:
      return launch<32>(dtype, q, k, v, out, B, Sq, Skv, H, Hkv, strides,
                        causal, has_window, window, scale, s);
    case 64:
      return launch<64>(dtype, q, k, v, out, B, Sq, Skv, H, Hkv, strides,
                        causal, has_window, window, scale, s);
    case 112:
      return launch<112>(dtype, q, k, v, out, B, Sq, Skv, H, Hkv, strides,
                         causal, has_window, window, scale, s);
    case 128:
      return launch<128>(dtype, q, k, v, out, B, Sq, Skv, H, Hkv, strides,
                         causal, has_window, window, scale, s);
    case 192:
      return launch<192>(dtype, q, k, v, out, B, Sq, Skv, H, Hkv, strides,
                         causal, has_window, window, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* flash_attention_error_string(int code) {
  return hopper::error_string(code);
}
