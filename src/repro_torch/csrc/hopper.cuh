// Hopper (sm_90a) building blocks shared by the port's kernels: mbarriers,
// TMA tensor loads, cp.async, wgmma descriptors and fences, the m64n64
// wgmma with its A operand in registers, and tensor maps encoded on the
// host and kept per (pointer, shape, strides, box).
//
// The tensor maps are encoded through libcuda's cuTensorMapEncodeTiled,
// reached with cudaGetDriverEntryPoint(ByVersion), so nothing links against
// libcuda.  A map describes a [B, S, Hx, D] tensor with unit stride over D
// (rank 4, innermost first: D, Hx, S, B) through the caller's strides; rows
// past S read as zeros.  A map encodes only those numbers and the box, so
// one kept for the same key is the same map: a prefill or a decode loop
// encodes each tensor's map once.

#pragma once

#include <array>
#include <cstdint>
#include <map>
#include <mutex>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace hopper {

// Returned (plus the CUresult) when a tensor map cannot be encoded; the
// entry points' error strings name it.
constexpr int kEncodeError = 10000;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// The barriers' initialisation, visible to the async proxy (TMA) and to the
// rest of the cluster.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.  A
// wait that outlasts 2^28 polls (seconds) can only be a lost copy: it traps,
// and the call fails, rather than hang the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  uint32_t polls = 0;
  do {
    if (++polls == (1u << 28)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a rank-4 tensor map (coordinates innermost first) into shared
// memory; its bytes complete on `bar`.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

// The tensor map's descriptor into the cache ahead of its first load.
__device__ __forceinline__ void prefetch_tensor_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// Barrier `id` (1..15; 0 is __syncthreads) over `threads` threads: wait
// there, or only count this warp's arrival.
__device__ __forceinline__ void named_barrier_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_barrier_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// 16 bytes from global to shared memory, bypassing L1; `src_bytes` of them
// are read and the rest filled with zeros (0: nothing is read).
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src,
                                            int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
// The barrier's arrival of this thread, made once its cp.async copies so far
// have landed (counted against the barrier's expected arrivals).
__device__ __forceinline__ void cp_async_mbar_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}
// This thread's cp.async copies so far as one group; wait until at most
// kPending of its groups are still in flight.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Shared-memory writes made by the generic proxy (st.shared, cp.async) that
// this thread has seen, ordered before its later accesses through the async
// proxy (wgmma, TMA).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// Narrow copies: the tiles TMA would write, filled by threads from rows that
// TMA cannot read (no whole number of 16 bytes, or an unaligned pointer or
// stride), in pieces of kW bf16 elements (16, 8, 4 or 2 bytes).
// ---------------------------------------------------------------------------

// `addr` (an offset from a 1024-byte aligned base) under the swizzle that
// TMA writes and wgmma reads for rows of `span` bytes (128, 64 or 32):
// address bits 4.. XOR bits 7.. (CUTLASS's Swizzle<log2(span / 16), 4, 3>).
__device__ __forceinline__ uint32_t swizzled(uint32_t addr, int span) {
  return addr ^ ((addr >> 3) & ((span / 16 - 1) << 4));
}

// The widest piece of kW elements (8, 4, 2 or 1) that a row of `cols` bf16
// elements at `ptr`, with element strides `strides` between rows, can be
// read in: kW divides cols and every stride, and 2 kW bytes divide the
// pointer.  A piece then lies wholly inside or wholly past a row.
inline int piece_elems(const void* ptr, int cols, const long long* strides,
                       int nstrides) {
  for (int w = 8; w > 1; w /= 2) {
    bool ok = cols % w == 0 && reinterpret_cast<uintptr_t>(ptr) % (2 * w) == 0;
    for (int i = 0; i < nstrides; ++i) ok = ok && strides[i] % w == 0;
    if (ok) return w;
  }
  return 1;
}

// A valid source for the copies that read nothing (a source size of 0).
static __device__ __align__(16) unsigned char kZeroPiece[16];

// One piece of kW elements from `src` into shared memory at `dst`, or kW
// zeros where `src` is null: cp.async of 16 (.cg), 8 or 4 bytes (.ca; the
// .cg form takes 16 only), with a source size of 0 for zeros; a 2-byte piece
// is a load and st.shared.
template <int kW>
__device__ __forceinline__ void copy_piece(uint32_t dst,
                                           const __nv_bfloat16* src) {
  const void* from = src ? static_cast<const void*>(src) : kZeroPiece;
  if constexpr (kW == 8) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(from), "r"(src ? 16 : 0)
                 : "memory");
  } else if constexpr (kW == 4 || kW == 2) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst),
                 "l"(from), "n"(2 * kW), "r"(src ? 2 * kW : 0)
                 : "memory");
  } else {
    const unsigned short v =
        src ? __ldg(reinterpret_cast<const unsigned short*>(src)) : 0;
    asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(dst), "h"(v) : "memory");
  }
}

// Rows [0, nrows) of a tile of kRows rows x kCols columns in the layout TMA
// writes with boxes of kBox columns (box b at dst + b kRows kBox 2, each row
// kBox 2 bytes under that span's swizzle): row r from row(r) (a pointer to
// its column 0, or null for a row of zeros), columns at or past `cols` (a
// multiple of kW) zero.  Thread `tid` of `nthreads` copies every nthreads-th
// piece, neighbouring threads along a row.  Where the threads cover whole
// rows (every tile of the expert FFN), a thread keeps one column and steps
// over rows; 8 rows or more at a time, its swizzled address only grows by
// a multiple of the swizzle's period (tools/moe_ab.py: the copies' own
// instructions set the narrow route's time at d 4092).
template <int kW, int kRows, int kCols, int kBox, typename RowFn>
__device__ __forceinline__ void copy_tile(uint32_t dst, int nrows, int cols,
                                          RowFn row, int tid, int nthreads) {
  constexpr int kPer = kCols / kW;                 // pieces a row
  constexpr int kSpan = kBox * 2;
  if (nthreads % kPer == 0) {
    const int c = (tid % kPer) * kW;
    const int step = nthreads / kPer;
    const bool in_row = c < cols;
    const uint32_t a0 = dst + (c / kBox) * (kRows * kSpan) + (c % kBox) * 2;
    if (step % 8 == 0) {
      uint32_t a = swizzled(a0 + tid / kPer * kSpan, kSpan);
#pragma unroll 4
      for (int r = tid / kPer; r < nrows; r += step, a += step * kSpan) {
        const __nv_bfloat16* src = row(r);
        copy_piece<kW>(a, src != nullptr && in_row ? src + c : nullptr);
      }
    } else {
#pragma unroll 4
      for (int r = tid / kPer; r < nrows; r += step) {
        const __nv_bfloat16* src = row(r);
        copy_piece<kW>(swizzled(a0 + r * kSpan, kSpan),
                       src != nullptr && in_row ? src + c : nullptr);
      }
    }
    return;
  }
  for (int i = tid; i < nrows * kPer; i += nthreads) {
    const int r = i / kPer;
    const int c = (i - r * kPer) * kW;
    const __nv_bfloat16* src = row(r);
    const uint32_t a =
        dst + (c / kBox) * (kRows * kSpan) + r * kSpan + (c % kBox) * 2;
    copy_piece<kW>(swizzled(a, kSpan),
                   src != nullptr && c < cols ? src + c : nullptr);
  }
}

// copy_tile with the piece width `w` (8, 4, 2 or 1) chosen at run time.
template <int kRows, int kCols, int kBox, typename RowFn>
__device__ __forceinline__ void copy_tile_w(int w, uint32_t dst, int nrows,
                                            int cols, RowFn row, int tid,
                                            int nthreads) {
  switch (w) {
    case 8:
      copy_tile<8, kRows, kCols, kBox>(dst, nrows, cols, row, tid, nthreads);
      break;
    case 4:
      copy_tile<4, kRows, kCols, kBox>(dst, nrows, cols, row, tid, nthreads);
      break;
    case 2:
      copy_tile<2, kRows, kCols, kBox>(dst, nrows, cols, row, tid, nthreads);
      break;
    default:
      copy_tile<1, kRows, kCols, kBox>(dst, nrows, cols, row, tid, nthreads);
  }
}

// This thread's narrow copies into a stage, announced on the stage's full
// barrier: two arrivals, one (release) for its st.shared, made visible to
// the async proxy first, one that the hardware makes once its cp.async
// copies have landed.
__device__ __forceinline__ void copies_arrive(uint32_t bar) {
  fence_proxy_async();
  mbar_arrive(bar);
  cp_async_mbar_arrive(bar);
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units) and the swizzle (1 = 128 B, 2 = 64 B, 3 = 32 B).
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most kPending committed wgmma groups are still running.
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
}

// Ties each accumulator register to this point, so that no read of it is
// scheduled between an asynchronous wgmma and the wait for it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// The same for a register A operand, which a running wgmma still reads.
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// d[32] += A * B, m64n64k16, A from registers (the m16n8k16 A fragment
// of the thread's warp), B MN-major in shared memory (transpose bit set).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess || found != cudaDriverEntryPointSuccess) p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// The map of a [B, S, Hx, D] tensor of `elem` bytes per element (element
// strides sb, ss, sh; unit stride over D), read in boxes of (box_d, 1, box_s,
// 1) with `swizzle`.  0, or kEncodeError + the CUresult.
inline int tensor_map(CUtensorMap* out, CUtensorMapDataType dtype, int elem,
                      const void* ptr, int B, int S, int Hx, int D,
                      long long sb, long long ss, long long sh, int box_d,
                      int box_s, CUtensorMapSwizzle swizzle) {
  // a dimension of extent 1 is never stepped: give it a packed stride
  if (Hx == 1) sh = D;
  if (S == 1) ss = Hx * sh;
  if (B == 1) sb = S * ss;
  using Key = std::array<uint64_t, 12>;
  const Key key = {reinterpret_cast<uint64_t>(ptr), uint64_t(dtype),
                   uint64_t(B),  uint64_t(S),  uint64_t(Hx),
                   uint64_t(D),  uint64_t(sb), uint64_t(ss),
                   uint64_t(sh), uint64_t(box_d), uint64_t(box_s),
                   uint64_t(swizzle)};
  static std::mutex mu;
  static std::map<Key, CUtensorMap> kept;
  std::lock_guard<std::mutex> lock(mu);
  const auto it = kept.find(key);
  if (it != kept.end()) {
    *out = it->second;
    return 0;
  }
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return kEncodeError + CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[4] = {cuuint64_t(D), cuuint64_t(Hx), cuuint64_t(S),
                              cuuint64_t(B)};
  const cuuint64_t strides[3] = {cuuint64_t(sh) * elem, cuuint64_t(ss) * elem,
                                 cuuint64_t(sb) * elem};
  const cuuint32_t box[4] = {cuuint32_t(box_d), 1, cuuint32_t(box_s), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  CUtensorMap map;
  const CUresult r = fn(&map, dtype, 4, const_cast<void*>(ptr), dims, strides,
                        box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return kEncodeError + static_cast<int>(r);
  if (kept.size() >= 4096) kept.clear();
  kept.emplace(key, map);
  *out = map;
  return 0;
}

// The instance width an attention kernel runs head dim D in: the smallest
// of the widths flash and flash-decode are built for that holds D, for every
// multiple of 8 from 8 to 256 (past D the kernels' own loads fill zeros);
// 0 for any other D.
inline int attention_width(int D) {
  static const int kWidths[] = {16, 32, 64, 80, 96, 112, 128, 192, 256};
  if (D < 8 || D > 256 || D % 8) return 0;
  for (const int w : kWidths)
    if (D <= w) return w;
  return 0;
}

inline const char* error_string(int code) {
  if (code >= kEncodeError)
    return "cuTensorMapEncodeTiled refused a tensor (the code less 10000 is "
           "its CUresult)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // namespace hopper
