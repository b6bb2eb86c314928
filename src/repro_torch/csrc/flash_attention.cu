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
// The kernel tiles by 64 x 64 where the reference tiles by 128 x 128; the
// online softmax gives the same function, and only the place where p is
// rounded (relative to the running max of a tile) moves: a bf16 result moves
// by a rounding step of p, an f32 one not at all.
//
// Grid.  One thread block per (q tile of 64 rows, batch row x q head); the
// loop over KV tiles inside the block takes the place of the reference's
// sequential kj grid axis.  q, k and v are read in place through their
// strides in the public [B, S, H, D] layout (no transpose, no repeat of K/V
// for GQA); the q tiles with the most keys are launched first.
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
// At H 32, Hkv 8, D 128, causal, the bytes bound it below S ~ 740 and the
// operations above: prefill is a tensor-core kernel.  What the design does
// about it: every intermediate stays on chip (scores, p, m, l and the
// accumulator never touch device memory), each K/V tile is read once per q
// tile as 16-byte vectors into shared memory, masked tiles are skipped, and
// in bf16 both products run on the tensor cores (mma.sync m16n8k16, f32
// accumulators) while the next K/V tile streams in by cp.async (double
// buffered).  Not yet done: TMA loads, wgmma and warp specialisation.
//
// Two paths, one arithmetic.
//   bf16 (flash_fwd_mma): 4 warps, warp w owns query rows 16 w .. 16 w + 15.
//     Its q fragments stay in registers; S = q K^T for a tile is 8 mma
//     accumulator tiles whose layout is the A operand layout of p V, so p is
//     rounded to bf16 and multiplied from registers.  Row max and row sum
//     are shuffles over the 4 lanes that share a row.  K and V fragments come
//     from shared memory by ldmatrix (V transposed).
//   f32 (flash_fwd, FMA on the CUDA cores; the tensor cores have no f32
//     product without TF32 rounding): 8 warps, warp w owns query rows
//     8 w .. 8 w + 7; for the scores a lane owns keys lane and lane + 32 of
//     the tile, for the output D / 32 neighbouring columns (D = 16: lanes
//     0..15, one column each); row max and sum are butterfly shuffles over
//     the warp; p goes through shared memory.
// Shared memory rows carry 16 bytes of padding, so 8 lanes reading 16 bytes
// each (or an ldmatrix phase) hit distinct banks.
//
// C interface (bound with ctypes): every pointer is a device pointer, the
// stream is the caller's current stream, nothing is allocated here, and the
// entry point returns the launch's cudaError_t (0 = launched).

#include <cmath>
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 8;
constexpr int kBQ = kWarps * kRowsPerWarp;   // query rows per block
constexpr int kBK = 64;                      // keys per KV tile
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

// N floats at p (4 N bytes, aligned to that) in one vector access.
template <int N>
__device__ __forceinline__ void load_f(const float* p, float (&out)[N]) {
  using R = typename Raw<4 * N>::type;
  const R raw = *reinterpret_cast<const R*>(p);
  const float* e = reinterpret_cast<const float*>(&raw);
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = e[i];
}

template <int N>
__device__ __forceinline__ void store_f(float* p, const float (&in)[N]) {
  using R = typename Raw<4 * N>::type;
  R raw;
  float* e = reinterpret_cast<float*>(&raw);
#pragma unroll
  for (int i = 0; i < N; ++i) e[i] = in[i];
  *reinterpret_cast<R*>(p) = raw;
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

// The KV tiles [kt_begin, kt_end) a q tile of rows [q0, q0 + rows) visits
// (see "Skipped tiles" above).
__device__ __forceinline__ void kv_tiles(int q0, int rows, int Sq, int Skv,
                                         int causal, int has_window,
                                         int window, int& kt_begin,
                                         int& kt_end) {
  const int off = Skv - Sq;
  const int q_lo = q0 + off;
  const int q_hi = min(q0 + rows, Sq) - 1 + off;
  kt_begin = 0;
  kt_end = (Skv + kBK - 1) / kBK;
  if (causal && q_lo >= 0 && (!has_window || window >= 1)) {
    kt_end = min(kt_end, q_hi / kBK + 1);
    if (has_window) kt_begin = max(0, (q_lo - window + 1) / kBK);
  }
}

// Score of query position qpos against key kpos, scaled and masked as the
// reference masks (-1e30); a key past the sequence gets -inf, so p = 0.
__device__ __forceinline__ float masked_score(float dot, float scale,
                                              int qpos, int kpos, int Skv,
                                              int causal, int has_window,
                                              int window) {
  if (kpos >= Skv) return -INFINITY;
  if ((causal && kpos > qpos) || (has_window && kpos <= qpos - window))
    return kMasked;
  return dot * scale;
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
  constexpr int kCols = D >= 32 ? D / 32 : 1;        // output columns per lane
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
// bf16 on the tensor cores: mma.sync m16n8k16 (f32 accumulators)
// ---------------------------------------------------------------------------

constexpr int kMmaWarps = 4;                 // 16 query rows each
constexpr int kMmaThreads = kMmaWarps * 32;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8 x 8 b16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8.  Plain: lane t gets M[t / 4][2 (t % 4) + {0, 1}] of each matrix;
// .trans: M[2 (t % 4) + {0, 1}][t / 4].
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c[16 x 8] += a[16 x 16] b[16 x 8]; lane t = 4 g + i holds c rows g and
// g + 8, columns 2 i and 2 i + 1.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 16 bytes from global to shared memory without passing through registers;
// zero-filled when !valid (no bytes are read then).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// load_tile's rows, issued as asynchronous copies (one commit group per
// call site; the caller waits for it).
template <int D, int kRows, int kNThreads>
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* dst, int ld,
                                                const __nv_bfloat16* src,
                                                long long stride_s, int row0,
                                                int rows) {
  constexpr int kVec = 8;
  constexpr int kPerRow = D / kVec;
  for (int i = threadIdx.x; i < kRows * kPerRow; i += kNThreads) {
    const int r = i / kPerRow;
    const int c = (i - r * kPerRow) * kVec;
    const bool valid = row0 + r < rows;
    cp_async16(dst + r * ld + c,
               valid ? src + (row0 + r) * stride_s + c : src, valid);
  }
}

template <int D>
struct MmaSmem {
  static constexpr int kLd = D + 8;          // 16 bytes of padding per row
  static constexpr size_t kTile = size_t(kBK) * kLd * sizeof(__nv_bfloat16);
  static constexpr size_t kBytes = 5 * kTile;   // q, and K and V twice
};

// Warp w owns query rows 16 w .. 16 w + 15 of the 64-row tile.  S = q K^T
// for the 64 keys of a tile is 8 accumulator tiles of 16 x 8; its layout is
// the A layout of the next product, so p (rounded to bf16) feeds p V from
// registers.  The q fragments stay in registers for the whole KV loop.
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_mma(const __nv_bfloat16* __restrict__ q,
              const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v,
              __nv_bfloat16* __restrict__ out, int Sq, int Skv, int H,
              int rep, long long q_sb, long long q_ss, long long q_sh,
              long long k_sb, long long k_ss, long long k_sh, long long v_sb,
              long long v_ss, long long v_sh, int causal, int has_window,
              int window, float scale) {
  using T = __nv_bfloat16;
  constexpr int kLd = MmaSmem<D>::kLd;
  constexpr int kDSteps = D / 16;            // k steps of q K^T
  constexpr int kDTiles = D / 8;             // n tiles of p V
  constexpr int kTileEl = kBK * kLd;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* Ks = Qs + kTileEl;                      // two buffers: tiles kt, kt + 1
  T* Vs = Ks + 2 * kTileEl;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;                   // accumulator row (and + 8)
  const int tig = lane & 3;                  // accumulator column pair
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int hk = h / rep;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;   // longest rows first
  const int off = Skv - Sq;

  load_tile<T, D, kBQ, kMmaThreads>(Qs, kLd, q + b * q_sb + h * q_sh, q_ss,
                                    q0, Sq);
  __syncthreads();
  uint32_t qf[kDSteps][4];
#pragma unroll
  for (int ks = 0; ks < kDSteps; ++ks)
    ldsm_x4(qf[ks], Qs + (warp * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * kLd +
                        ks * 16 + (lane >> 4) * 8);

  int kt_begin, kt_end;
  kv_tiles(q0, kBQ, Sq, Skv, causal, has_window, window, kt_begin, kt_end);
  const T* kb = k + b * k_sb + hk * k_sh;
  const T* vb = v + b * v_sb + hk * v_sh;
  const int qpos0 = q0 + warp * 16 + g + off;          // row g; row g + 8 is +8

  float o[kDTiles][4];
#pragma unroll
  for (int j = 0; j < kDTiles; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m_r[2] = {kMasked, kMasked};
  float l_r[2] = {0.f, 0.f};

  // K/V tiles are double-buffered: tile kt + 1 streams in (cp.async) while
  // tile kt is computed.
  if (kt_begin < kt_end) {
    load_tile_async<D, kBK, kMmaThreads>(Ks, kLd, kb, k_ss, kt_begin * kBK,
                                         Skv);
    load_tile_async<D, kBK, kMmaThreads>(Vs, kLd, vb, v_ss, kt_begin * kBK,
                                         Skv);
    cp_async_commit();
  }
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBK;
    const int buf = (kt - kt_begin) & 1;
    if (kt + 1 < kt_end) {
      // the other buffer's readers finished at the end of the last tile
      load_tile_async<D, kBK, kMmaThreads>(Ks + (buf ^ 1) * kTileEl, kLd, kb,
                                           k_ss, k0 + kBK, Skv);
      load_tile_async<D, kBK, kMmaThreads>(Vs + (buf ^ 1) * kTileEl, kLd, vb,
                                           v_ss, k0 + kBK, Skv);
      cp_async_commit();
      cp_async_wait<1>();                    // tile kt has landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* Kt = Ks + buf * kTileEl;
    const T* Vt = Vs + buf * kTileEl;

    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kDSteps; ++ks) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {       // keys 16 np .. 16 np + 15
        uint32_t kf[4];
        ldsm_x4(kf, Kt + (np * 16 + (lane >> 4) * 8 + (lane & 7)) * kLd +
                        ks * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * np], qf[ks], kf[0], kf[1]);
        mma_bf16(s[2 * np + 1], qf[ks], kf[2], kf[3]);
      }
    }

    // mask and online softmax for rows g (r = 0) and g + 8 (r = 1)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qpos = qpos0 + 8 * r;
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[n][2 * r + e];
          x = masked_score(x, scale, qpos, k0 + n * 8 + 2 * tig + e, Skv,
                           causal, has_window, window);
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_r[r], mx);
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[n][2 * r + e];
          x = expf(x - m_new);
          sum += x;
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float alpha = expf(m_r[r] - m_new);
      l_r[r] = l_r[r] * alpha + sum;
      m_r[r] = m_new;
#pragma unroll
      for (int j = 0; j < kDTiles; ++j) {
        o[j][2 * r] *= alpha;
        o[j][2 * r + 1] *= alpha;
      }
    }

    // o += p V, p rounded to bf16 (v's dtype) as the A operand
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {         // keys 16 kk .. 16 kk + 15
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < kDTiles / 2; ++dp) {
        uint32_t vf[4];
        ldsm_x4_trans(vf, Vt + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) *
                                   kLd + dp * 16 + (lane >> 4) * 8);
        mma_bf16(o[2 * dp], pa, vf[0], vf[1]);
        mma_bf16(o[2 * dp + 1], pa, vf[2], vf[3]);
      }
    }
    __syncthreads();                         // this buffer's readers are done
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row < Sq) {
      const float inv = 1.f / fmaxf(l_r[r], 1e-30f);
      T* dst = out + ((static_cast<long long>(b) * Sq + row) * H + h) * D +
               2 * tig;
#pragma unroll
      for (int j = 0; j < kDTiles; ++j)
        *reinterpret_cast<uint32_t*>(dst + j * 8) =
            pack_bf16(o[j][2 * r] * inv, o[j][2 * r + 1] * inv);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Skv, int H, int Hkv, const long long* st, int causal,
           int has_window, int window, float scale, void* stream) {
  constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value;
  constexpr size_t kBytes = kMma ? MmaSmem<D>::kBytes : Smem<D>::kBytes;
  constexpr int kN = kMma ? kMmaThreads : kThreads;
  const void* fn;
  if constexpr (kMma)
    fn = reinterpret_cast<const void*>(flash_fwd_mma<D>);
  else
    fn = reinterpret_cast<const void*>(flash_fwd<D>);
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kBytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((Sq + kBQ - 1) / kBQ, B * H);
  const auto strm = static_cast<cudaStream_t>(stream);
  if constexpr (kMma)
    flash_fwd_mma<D><<<grid, kN, kBytes, strm>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(out), Sq, Skv, H, H / Hkv,
        st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
        causal, has_window, window, scale);
  else
    flash_fwd<D><<<grid, kN, kBytes, strm>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(out), Sq, Skv, H, H / Hkv,
        st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
        causal, has_window, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int D, const void* q, const void* k, const void* v, void* out,
             int B, int Sq, int Skv, int H, int Hkv, const long long* st,
             int causal, int has_window, int window, float scale,
             void* stream) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, out, B, Sq, Skv, H, Hkv, st, causal,
                           has_window, window, scale, stream);
    case 32:
      return launch<T, 32>(q, k, v, out, B, Sq, Skv, H, Hkv, st, causal,
                           has_window, window, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, out, B, Sq, Skv, H, Hkv, st, causal,
                           has_window, window, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, out, B, Sq, Skv, H, Hkv, st, causal,
                            has_window, window, scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q [B, Sq, H, D], k/v [B, Skv, Hkv, D],
// each with unit stride over D and the (batch, sequence, head) strides in
// `strides` (q's three, then k's, then v's, in elements); out is a contiguous
// [B, Sq, H, D].  D in {16, 32, 64, 128}; H a multiple of Hkv.
extern "C" int flash_attention_fwd(int dtype, const void* q, const void* k,
                                   const void* v, void* out, int B, int Sq,
                                   int Skv, int H, int Hkv, int D,
                                   const long long* strides, int causal,
                                   int has_window, int window, float scale,
                                   void* stream) {
  if (Sq <= 0 || Skv <= 0 || B <= 0) return 0;
  if (dtype == 0)
    return dispatch<float>(D, q, k, v, out, B, Sq, Skv, H, Hkv, strides,
                           causal, has_window, window, scale, stream);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(D, q, k, v, out, B, Sq, Skv, H, Hkv,
                                   strides, causal, has_window, window, scale,
                                   stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
