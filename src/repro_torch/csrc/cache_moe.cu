// Slot-indexed grouped expert FFN for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU stages that the reference's cache_moe runs
// (src/repro/kernels/cache_moe.py):
//   stage 1, swiglu experts (reached from cache_moe.py:191):
//            src/repro/kernels/moe_gemm.py::_gate_up_kernel (moe_gemm.py:28,
//            pallas_call at moe_gemm.py:74):  h = silu(x @ wg) * (x @ wu)
//   stage 1, gelu experts (wg = None):
//            src/repro/kernels/cache_moe.py::_up_gelu_kernel (cache_moe.py:120,
//            pallas_call at cache_moe.py:143):  h = gelu_tanh(x @ wu)
//   stage 2  src/repro/kernels/moe_gemm.py::_down_kernel (moe_gemm.py:47,
//            pallas_call at moe_gemm.py:91, and cache_moe.py:157 under gelu):
//            y = h @ wd
//
// What it computes.  The (token, choice) pairs of a verify block are sorted
// by cache slot on the device (repro_torch/kernels/cache_moe.py::slot_groups,
// fixed shapes, no host sync).  Group g owns the sorted rows
// [grp_start[g], grp_start[g] + grp_count[g]), all routed to slot
// grp_slot[g].  Stage 1 writes h[p] = silu(x[row_tok[p]] @ wg[s]) *
// (x[row_tok[p]] @ wu[s]), or for gelu experts h[p] = gelu_tanh(x[row_tok[p]]
// @ wu[s]) = 0.5 a (1 + tanh(sqrt(2/pi) (a + 0.044715 a^3))) with tanhf (what
// jax.nn.gelu computes by default), in x's dtype (f32 accumulators, as the
// Pallas kernels' h_ref.dtype); stage 2 writes y[p] = h[p] @ wd[s].  The three
// are one template per route (slot_ffn_tc for bf16, slot_ffn for f32) with
// the epilogue as its parameter.  The weights are read straight out of the [S, d, f] / [S, f, d] slot pool: nothing gathers
// or copies a weight row.  Groups with no rows exit at once, so misses and
// unoccupied slots cost nothing.
//
// Bound.  Each touched slot's weights are read once and each row's input
// and output moved once:
//   bytes = M_touched * m * d * f * 2 + rows * (d + f) * 2       (bf16)
//   flops = 2 * m * rows * d * f
// with m the stage's matrices (2 for swiglu's stage 1, else 1).
// A verify block (T = 5, top-2) gives each touched slot a row or two: at
// d = 4096, f = 14336 with 8 slots touched, stage 1 (two matrices) is
// 1.88 GB, 0.561 ms at the H100's 3.35 TB/s, stage 2 0.281 ms; the
// operations are ~1 % of the bf16 tensor-core rate.  A 512-token prefill
// block gives each slot ~128 rows and is still bound by the bytes (0.561 /
// 0.281 ms against 0.243 / 0.122 ms of operations) if each slot's weights
// are read once.
//
// bf16 (slot_ffn_tc): the weights stream through a TMA ring and the rows
// meet them on the tensor cores.
//   * A block owns 64 (or 128) output columns of one group: grid
//     (ceil(N / 64), groups), so stage 2's 4096 columns give 64 blocks per
//     slot and every SM streams (the FMA kernel had 16 column tiles of 256).
//   * Producer warps, after the consumers, bring weight tiles of 64
//     reduction rows x 64 columns (8 KB a matrix) by TMA
//     (cp.async.bulk.tensor through a tensor map of the [S, K, N] pool,
//     128-byte swizzle) into a ring of 4-10 stages on full / empty
//     mbarriers: 64-160 KB of weights in flight per SM and no block-wide
//     barrier in the stream.  The same warps copy the pass's rows of the
//     input (x[row_tok[p]], gathered, or h[p]) for those 64 reduction
//     elements with cp.async into the stage, in the swizzled K-major layout
//     wgmma reads; the hardware arrives on the stage's full barrier for
//     each lane once its copies land (cp.async.mbarrier.arrive), and the
//     consumers fence them for the async proxy.
//   * The row products are wgmma with A and B swapped: D [64 columns x N
//     rows] += W^T [64 x 16] X^T [16 x N], the weight tile MN-major through
//     the transpose bit.  Two block shapes, picked by the call's row count
//     (TcLayout): verify blocks (up to 64 rows) take N = 16, one consumer
//     warpgroup and two blocks per SM; the prefill block takes two consumer
//     warpgroups and 256 rows a pass (N = 128 for swiglu's two
//     accumulators, N = 256 on 128 columns for the one-matrix stages), so
//     the 512-token prefill block reads each slot's weights once, not once
//     per 8 rows.  A warpgroup with no rows in a pass skips its products.
//   * Batch invariance: an output element is the f32 sum of its 64-element
//     tiles in order, each four k16 products, whatever the row count, the
//     groups, the block shape or the row's place in the tile (wgmma's N
//     does not change an element's sum: chip_smoke.py holds the T 512
//     call's rows, N = 128 / 256, to their T 1 calls, N = 16, bit for bit).
//     One block owns the whole reduction: no split of K, no atomics.
//   * The epilogues (linear, silu(a) * b, tanh-gelu) run in f32 on the
//     accumulators; each output is rounded to bf16 once.
//   What the A/B runs showed (tools/moe_ab.py): a producer that waited for
//   its copies before arriving ran at one tile per round trip to L2; one
//   producer warp could not issue the prefill block's ~128 rows a tile
//   (the copies, not the products or the weights, set its time: four warps
//   took swiglu's T 512 call from 1.48 to 0.88 ms); N = 128 for every call
//   spent ~40 us of a verify block's 0.36 ms on products of empty rows.
// f32 (slot_ffn): FMA on the CUDA cores (the tensor cores have no f32
// product without TF32 rounding).  Neighbouring threads own neighbouring
// output columns (one 16-byte load of a weight row each), each weight
// element is applied to up to kRows rows of its slot, and the reduction is
// split over the block's 8 warps in a fixed pattern added in warp order:
// the same batch invariance.
//
// C interface (bound with ctypes): every pointer is a device pointer, the
// stream is the caller's current stream, nothing is allocated on the device
// here, and each entry point returns the launch's cudaError_t (0 =
// launched), or hopper::kEncodeError + the CUresult when a weight tensor
// map cannot be encoded (maps are kept per pool, hopper.cuh).

#include <cstdint>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

using hopper::cp_async_16;
using hopper::fence_proxy_async;
using hopper::mbar_arrive;
using hopper::mbar_expect_tx;
using hopper::mbar_init;
using hopper::mbar_wait;
using hopper::smem_addr;
using hopper::tma_load_4d;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 8;                 // rows of one slot per pass
constexpr int kChunk = 512;              // reduction elements staged per step
constexpr int kPerWarp = kChunk / kWarps;

// stage epilogues
constexpr int kLinear = 0;               // out = in_row @ w1
constexpr int kSwiglu = 1;               // out = silu(in_row @ w1) * (in_row @ w2)
constexpr int kGelu = 2;                 // out = gelu_tanh(in_row @ w1)

template <typename T>
struct Traits;

template <>
struct Traits<float> {
  static constexpr int kVec = 4;         // 16 bytes
  __device__ static float to_f(float v) { return v; }
  __device__ static float from_f(float v) { return v; }
  __device__ static void load(const float* p, float (&v)[4]) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = a.x;
    v[1] = a.y;
    v[2] = a.z;
    v[3] = a.w;
  }
};

// out[p, :N] for the rows p of group blockIdx.y, columns of tile blockIdx.x,
// with the epilogue kAct (kLinear, kSwiglu or kGelu) applied to the f32 sums.
// in_row is in[row_map[p]] when row_map is given, else in[p].
template <typename T, int kAct>
__global__ void __launch_bounds__(kThreads)
slot_ffn(const T* __restrict__ in, const int* __restrict__ row_map,
         const T* __restrict__ w1, const T* __restrict__ w2,
         const int* __restrict__ grp_slot, const int* __restrict__ grp_start,
         const int* __restrict__ grp_count, T* __restrict__ out, int K, int N) {
  using Tr = Traits<T>;
  constexpr int V = Tr::kVec;
  constexpr int kCols = 32 * V;
  constexpr bool kGated = kAct == kSwiglu;
  constexpr int kAcc = kGated ? 2 : 1;
  __shared__ float xs[kRows][kChunk];
  __shared__ float red[kAcc][kWarps][kCols];

  const int g = blockIdx.y;
  const int count = grp_count[g];
  if (count <= 0) return;                // uniform across the block
  const int start = grp_start[g];
  const size_t slot = static_cast<size_t>(grp_slot[g]);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int col0 = blockIdx.x * kCols;
  const int j = col0 + lane * V;
  const bool col_ok = j < N;
  const size_t plane = static_cast<size_t>(K) * static_cast<size_t>(N);
  const T* a_base = w1 + slot * plane + j;
  const T* b_base = kGated ? w2 + slot * plane + j : nullptr;

  for (int p0 = 0; p0 < count; p0 += kRows) {
    const int nrows = min(kRows, count - p0);
    float acc[kAcc][kRows][V];
#pragma unroll
    for (int a = 0; a < kAcc; ++a)
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int v = 0; v < V; ++v) acc[a][r][v] = 0.f;

    for (int k0 = 0; k0 < K; k0 += kChunk) {
      __syncthreads();                   // last step's readers are done
      for (int idx = threadIdx.x; idx < nrows * kChunk; idx += kThreads) {
        const int r = idx / kChunk;
        const int kk = idx - r * kChunk;
        const int p = start + p0 + r;
        const size_t row = static_cast<size_t>(row_map ? row_map[p] : p);
        const int k = k0 + kk;
        xs[r][kk] = k < K ? Tr::to_f(in[row * K + k]) : 0.f;
      }
      __syncthreads();
      const int kb = k0 + warp * kPerWarp;
      const int kn = min(kPerWarp, K - kb);
      if (col_ok) {
#pragma unroll 4
        for (int kk = 0; kk < kn; ++kk) {
          const size_t off = static_cast<size_t>(kb + kk) * N;
          float a[V];
          Tr::load(a_base + off, a);
          float b[V];
          if constexpr (kGated) Tr::load(b_base + off, b);
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            if (r < nrows) {
              const float xv = xs[r][warp * kPerWarp + kk];
#pragma unroll
              for (int v = 0; v < V; ++v) {
                acc[0][r][v] = fmaf(xv, a[v], acc[0][r][v]);
                if constexpr (kGated) acc[1][r][v] = fmaf(xv, b[v], acc[1][r][v]);
              }
            }
          }
        }
      }
    }

    // Partial sums of the 8 warps, added in warp order, one row at a time.
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r < nrows) {
        __syncthreads();
#pragma unroll
        for (int a = 0; a < kAcc; ++a)
#pragma unroll
          for (int v = 0; v < V; ++v) red[a][warp][lane * V + v] = acc[a][r][v];
        __syncthreads();
        for (int c = threadIdx.x; c < kCols; c += kThreads) {
          const int col = col0 + c;
          if (col < N) {
            float s0 = 0.f;
            float s1 = 0.f;
#pragma unroll
            for (int w = 0; w < kWarps; ++w) {
              s0 += red[0][w][c];
              if constexpr (kGated) s1 += red[1][w][c];
            }
            float val = s0;
            if constexpr (kGated) val = s0 / (1.f + expf(-s0)) * s1;
            if constexpr (kAct == kGelu)
              val = 0.5f * s0 *
                    (1.f + tanhf(0.7978845608028654f *
                                 (s0 + 0.044715f * s0 * s0 * s0)));
            out[static_cast<size_t>(start + p0 + r) * N + col] = Tr::from_f(val);
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores: a TMA weight ring, wgmma row products
// ---------------------------------------------------------------------------

constexpr int kTcCols = 64;              // output columns per block: wgmma M
constexpr int kTcK = 64;                 // reduction elements per tile
constexpr int kWTile = kTcK * kTcCols * 2;     // one weight tile, 8 KB

// The shapes of a block: kWG consumer warpgroups of kN rows each (wgmma's
// N), in kCG groups of 64 output columns (the block's kBN = 64 kCG columns)
// by kWG / kCG groups of rows.  The small shape (16 rows a pass, one
// warpgroup, two blocks per SM) serves verify blocks; the large ones (256
// rows a pass) the prefill block, whose ~128 rows a slot then read the
// slot's weights once: swiglu as two warpgroups of 128 rows on 64 columns
// (two accumulators of 64 registers), the one-matrix stages as two of 256
// rows on 128 columns, which halves the rows' copies a column sees and
// doubles the weight bytes a stage holds.
template <int kAct, int kN, int kWG, int kCG>
struct TcLayout {
  static constexpr int kMats = kAct == kSwiglu ? 2 : 1;
  static constexpr int kBN = kTcCols * kCG;              // columns per block
  static constexpr int kWBytes = kCG * kWTile;           // a matrix's tiles
  static constexpr int kPass = kN * (kWG / kCG);         // rows per pass
  static constexpr int kXTile = kPass * kTcK * 2;        // the rows' tile
  static constexpr int kXAlloc = kXTile < 1024 ? 1024 : kXTile;
  static constexpr int kStage = kMats * kWBytes + kXAlloc;
  static constexpr int kBlocks = kPass <= 16 ? 2 : 1;    // per SM
  static constexpr int kStages = (kBlocks == 2 ? 96 : 200) * 1024 / kStage;
  static constexpr int kBar = kStages * kStage;
  static constexpr int kBytes = 1024 + kBar + 16 * kStages;
  static constexpr int kConsumers = kWG * 128;
  // producer warps: the large shape copies ~128 rows a tile, which one warp
  // issued too slowly (tools/moe_ab.py: the copies, not the products or
  // the weights, set its time)
  static constexpr int kProducers = kPass <= 16 ? 1 : 4;
  static constexpr int kThreads = kConsumers + 32 * kProducers;
};

// d[kN / 2] += A * B, m64nNk16 (N = 16, 128 or 256): A MN-major (the
// weight tile, transpose bit), B K-major (the rows), both in shared memory.
__device__ __forceinline__ void wgmma_tn(float (&d)[8], uint64_t a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b));
}
__device__ __forceinline__ void wgmma_tn(float (&d)[64], uint64_t a,
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
      "}, %64, %65, p, 1, 1, 1, 0;\n}\n"
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
      : "l"(a), "l"(b));
}

__device__ __forceinline__ void wgmma_tn(float (&d)[128], uint64_t a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 1, 0;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b));
}

// Shared memory: kStages stages of [w1 tiles][w2 tiles (swiglu)][rows
// tile], each 1024-aligned, then the full and empty mbarriers.  A weight
// tile is kTcK rows of the [K, N] matrix x 64 columns (128 bytes, the
// 128-byte swizzle as TMA writes it; kCG of them side by side): the
// MN-major A operand.  The rows tile is
// kPass rows x kTcK reduction elements (128 bytes a row, swizzled the same
// way by the producer's copies): the K-major B operand.
//
// out[p, col0 .. col0 + kBN - 1] for the rows p of group blockIdx.y, with the
// epilogue kAct on the f32 sums; in_row is in[row_map[p]] when row_map is
// given, else in[p].  The consumer warpgroups come first, then the producer
// warps.  The work of a block is `passes` passes over the group's rows, each
// of ceil(K / 64) tiles; producer and consumers walk the same sequence of
// tiles through the ring.
template <int kAct, int kN, int kWG, int kCG>
__global__ void __launch_bounds__(TcLayout<kAct, kN, kWG, kCG>::kThreads,
                                  TcLayout<kAct, kN, kWG, kCG>::kBlocks)
slot_ffn_tc(const __grid_constant__ CUtensorMap tm_w1,
            const __grid_constant__ CUtensorMap tm_w2,
            const __nv_bfloat16* __restrict__ in,
            const int* __restrict__ row_map, const int* __restrict__ grp_slot,
            const int* __restrict__ grp_start,
            const int* __restrict__ grp_count,
            __nv_bfloat16* __restrict__ out, int K, int N) {
  using L = TcLayout<kAct, kN, kWG, kCG>;
  constexpr bool kGated = kAct == kSwiglu;
  const int g = blockIdx.y;
  const int count = grp_count[g];
  if (count <= 0) return;                // uniform across the block
  const int start = grp_start[g];
  const int slot = grp_slot[g];
  const int col0 = blockIdx.x * L::kBN;
  const int ktiles = (K + kTcK - 1) / kTcK;
  const int passes = (count + L::kPass - 1) / L::kPass;
  const int total = passes * ktiles;

  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const auto w1s = [&](int s) { return base + s * L::kStage; };
  const auto xs = [&](int s) { return w1s(s) + L::kMats * L::kWBytes; };
  const auto full = [&](int s) { return base + L::kBar + 8 * s; };
  const auto empty = [&](int s) {
    return base + L::kBar + 8 * (L::kStages + s);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < L::kStages; ++s) {
      // the weights' bytes, and each producer lane's rows
      mbar_init(full(s), 1 + 32 * L::kProducers);
      mbar_init(empty(s), L::kConsumers / 32);  // every consumer warp
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();                       // the only block-wide barrier

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= L::kConsumers / 32) {
    // The producers: weight tiles by TMA (lane 0 of the first), the rows'
    // tile by cp.async (every lane), stage by stage as the consumers release
    // them.  Producer lane l copies 16-byte piece l % 8 of rows l / 8 +
    // kLanes / 8 * i (eight lanes read a row's 128 bytes), whose sources it
    // looks up once per pass; each lane's arrival on the stage's full
    // barrier is made by the hardware once its copies have landed, so no
    // producer waits for them.
    constexpr int kLanes = 32 * L::kProducers;
    const int pl = threadIdx.x - L::kConsumers;
    const bool issuer = pl == 0;
    if (issuer) {
      hopper::prefetch_tensor_map(&tm_w1);
      if constexpr (kGated) hopper::prefetch_tensor_map(&tm_w2);
    }
    constexpr int kStep = kLanes / 8;        // rows between a lane's rows
    constexpr int kPer = L::kPass / kStep;   // rows a lane copies per pass
    const int c = pl & 7;
    int src[kPer];                           // the lane's rows' input rows
    int rows = 0;
    for (int it = 0; it < total; ++it) {
      const int s = it % L::kStages;
      const int pass = it / ktiles;
      const int kt = it - pass * ktiles;
      if (kt == 0) {
        rows = min(L::kPass, count - pass * L::kPass);
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          const int r = (pl >> 3) + kStep * i;
          if (r >= rows) break;
          const int p = start + pass * L::kPass + r;
          src[i] = row_map ? row_map[p] : p;
        }
      }
      if (it >= L::kStages) mbar_wait(empty(s), ((it / L::kStages) & 1) ^ 1);
      const int k0 = kt * kTcK;
      if (issuer) {
        mbar_expect_tx(full(s), L::kMats * L::kWBytes);
#pragma unroll
        for (int cb = 0; cb < kCG; ++cb) {
          tma_load_4d(w1s(s) + cb * kWTile, &tm_w1, full(s),
                      col0 + cb * kTcCols, 0, k0, slot);
          if constexpr (kGated)
            tma_load_4d(w1s(s) + L::kWBytes + cb * kWTile, &tm_w2, full(s),
                        col0 + cb * kTcCols, 0, k0, slot);
        }
      }
      // rows past the pass's are not copied: they are columns of B whose
      // outputs are never stored; pieces past K are zeros
      const int k = k0 + 8 * c;
      const int nbytes = k < K ? 16 : 0;
      const __nv_bfloat16* from = in + (k < K ? k : 0);
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int r = (pl >> 3) + kStep * i;
        if (r >= rows) break;                // the pass's rows only
        cp_async_16(xs(s) + r * 128 + ((c ^ (r & 7)) << 4),
                    from + static_cast<size_t>(src[i]) * K, nbytes);
      }
      hopper::cp_async_mbar_arrive(full(s));
    }
    return;
  }

  // Consumers.  Warpgroup cg takes columns 64 (cg % kCG) + 0..63 and rows
  // kN (cg / kCG) + 0..kN-1 of a pass: D [64 columns x kN rows] += W^T [64
  // x 16] X^T [16 x kN], four k16 steps a tile.  A warpgroup with no rows
  // in a pass only paces itself on the full barriers and releases each
  // stage.  Lane t of warp w holds output columns 16 w + t / 4 (+ 8) of
  // rows 8 j + 2 (t % 4) (+ 1).
  const int cg = threadIdx.x / 128;
  const int cb = cg % kCG;
  const int ccol0 = col0 + cb * kTcCols;
  const int w = warp & 3;
  const int tg = lane >> 2;
  const int tq = lane & 3;
  const auto release = [&](int s) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));
  };
  int it = 0;
  for (int pass = 0; pass < passes; ++pass) {
    const int pr = pass * L::kPass + cg / kCG * kN;   // its row 0
    const bool active = pr < count;
    float a1[kN / 2];
    float a2[kGated ? kN / 2 : 1];
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) a1[i] = 0.f;
#pragma unroll
    for (int i = 0; i < (kGated ? kN / 2 : 1); ++i) a2[i] = 0.f;
    int prev = -1;
    for (int kt = 0; kt < ktiles; ++kt, ++it) {
      const int s = it % L::kStages;
      mbar_wait(full(s), (it / L::kStages) & 1);
      if (active) {
        fence_proxy_async();             // the rows, copied by cp.async
        const uint64_t da =
            hopper::gmma_desc(w1s(s) + cb * kWTile, kWTile, 1024, 1);
        const uint64_t db =
            hopper::gmma_desc(xs(s) + cg / kCG * kN * 128, 16, 1024, 1);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kTcK / 16; ++kk)   // 16 weight rows: 2048 B
          wgmma_tn(a1, da + kk * 128, db + kk * 2);
        if constexpr (kGated) {
#pragma unroll
          for (int kk = 0; kk < kTcK / 16; ++kk)
            wgmma_tn(a2, da + (L::kWBytes >> 4) + kk * 128, db + kk * 2);
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<1>();         // the tile before this one is done
      }
      if (prev >= 0) release(prev);
      prev = s;
    }
    if (active) {
      hopper::wgmma_wait<0>();
      hopper::fence_regs(a1);
      hopper::fence_regs(a2);
    }
    release(prev);
    if (!active) continue;
#pragma unroll
    for (int j = 0; j < kN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = pr + 8 * j + 2 * tq + (e & 1);
        const int col = ccol0 + 16 * w + tg + 8 * (e >> 1);
        if (p < count && col < N) {
          const float s0 = a1[4 * j + e];
          float val = s0;
          if constexpr (kGated) val = s0 / (1.f + expf(-s0)) * a2[4 * j + e];
          if constexpr (kAct == kGelu)
            val = 0.5f * s0 *
                  (1.f + tanhf(0.7978845608028654f *
                               (s0 + 0.044715f * s0 * s0 * s0)));
          out[static_cast<size_t>(start + p) * N + col] = __float2bfloat16(val);
        }
      }
  }
}

template <typename T, int kAct>
int launch(const void* in, const void* row_map, const void* w1, const void* w2,
           const void* grp_slot, const void* grp_start, const void* grp_count,
           void* out, int K, int N, int groups, void* stream) {
  constexpr int kCols = 32 * Traits<T>::kVec;
  if (groups <= 0) return 0;
  const dim3 grid((N + kCols - 1) / kCols, groups);
  slot_ffn<T, kAct><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(in), static_cast<const int*>(row_map),
      static_cast<const T*>(w1), static_cast<const T*>(w2),
      static_cast<const int*>(grp_slot), static_cast<const int*>(grp_start),
      static_cast<const int*>(grp_count), static_cast<T*>(out), K, N);
  return static_cast<int>(cudaGetLastError());
}

// The weights of a [slots, K, N] pool as a tensor map, read in tiles of
// kTcK rows x kTcCols columns with the 128-byte swizzle.
inline int weight_map(CUtensorMap* m, const void* w, int slots, int K, int N) {
  return hopper::tensor_map(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, w, slots,
                            K, 1, N, static_cast<long long>(K) * N, N, N,
                            kTcCols, kTcK, CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int kAct, int kN, int kWG, int kCG>
int launch_shape(const CUtensorMap& m1, const CUtensorMap& m2,
                 const void* in, const void* row_map, const void* grp_slot,
                 const void* grp_start, const void* grp_count, void* out,
                 int K, int N, int groups, void* stream) {
  using L = TcLayout<kAct, kN, kWG, kCG>;
  static const cudaError_t ready = cudaFuncSetAttribute(
      slot_ffn_tc<kAct, kN, kWG, kCG>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (ready != cudaSuccess) return static_cast<int>(ready);
  const dim3 grid((N + L::kBN - 1) / L::kBN, groups);
  slot_ffn_tc<kAct, kN, kWG, kCG><<<grid, L::kThreads, L::kBytes,
                                    static_cast<cudaStream_t>(stream)>>>(
      m1, m2, static_cast<const __nv_bfloat16*>(in),
      static_cast<const int*>(row_map), static_cast<const int*>(grp_slot),
      static_cast<const int*>(grp_start), static_cast<const int*>(grp_count),
      static_cast<__nv_bfloat16*>(out), K, N);
  return static_cast<int>(cudaGetLastError());
}

// `rows` is the call's row count (T * k), which bounds every group's: up to
// 64 rows (verify blocks and fused rounds: a few rows a slot) take the small
// shape, more the large one.
template <int kAct>
int launch_tc(const void* in, const void* row_map, const void* w1,
              const void* w2, const void* grp_slot, const void* grp_start,
              const void* grp_count, void* out, int K, int N, int slots,
              int groups, int rows, void* stream) {
  if (groups <= 0) return 0;
  CUtensorMap m1, m2;
  int rc = weight_map(&m1, w1, slots, K, N);
  if (rc == 0) rc = w2 ? weight_map(&m2, w2, slots, K, N) : 0;
  if (rc) return rc;
  if (!w2) m2 = m1;
  if (rows <= 64)
    return launch_shape<kAct, 16, 1, 1>(m1, m2, in, row_map, grp_slot,
                                        grp_start, grp_count, out, K, N,
                                        groups, stream);
  if constexpr (kAct == kSwiglu)
    return launch_shape<kAct, 128, 2, 1>(m1, m2, in, row_map, grp_slot,
                                         grp_start, grp_count, out, K, N,
                                         groups, stream);
  else
    return launch_shape<kAct, 256, 2, 2>(m1, m2, in, row_map, grp_slot,
                                         grp_start, grp_count, out, K, N,
                                         groups, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  x [T, d], row_tok [P], wg/wu [S, d, f]
// with S = slots, grp_* [groups] -> h [P, f] with P = rows.  bf16 needs d
// and f to be multiples of 8 (16-byte rows).
extern "C" int cache_moe_gate_up(int dtype, const void* x, const void* row_tok,
                                 const void* wg, const void* wu,
                                 const void* grp_slot, const void* grp_start,
                                 const void* grp_count, void* h, int d, int f,
                                 int slots, int rows, int groups,
                                 void* stream) {
  if (dtype == 0)
    return launch<float, kSwiglu>(x, row_tok, wg, wu, grp_slot, grp_start,
                                  grp_count, h, d, f, groups, stream);
  if (dtype == 1)
    return launch_tc<kSwiglu>(x, row_tok, wg, wu, grp_slot, grp_start,
                              grp_count, h, d, f, slots, groups, rows,
                              stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Gelu experts.  x [T, d], row_tok [P], wu [S, d, f], grp_* [groups] -> h [P, f].
extern "C" int cache_moe_up_gelu(int dtype, const void* x, const void* row_tok,
                                 const void* wu, const void* grp_slot,
                                 const void* grp_start, const void* grp_count,
                                 void* h, int d, int f, int slots, int rows,
                                 int groups, void* stream) {
  if (dtype == 0)
    return launch<float, kGelu>(x, row_tok, wu, nullptr, grp_slot, grp_start,
                                grp_count, h, d, f, groups, stream);
  if (dtype == 1)
    return launch_tc<kGelu>(x, row_tok, wu, nullptr, grp_slot, grp_start,
                            grp_count, h, d, f, slots, groups, rows, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// h [P, f], wd [S, f, d], grp_* [groups] -> y [P, d] with P = rows.
extern "C" int cache_moe_down(int dtype, const void* h, const void* wd,
                              const void* grp_slot, const void* grp_start,
                              const void* grp_count, void* y, int f, int d,
                              int slots, int rows, int groups, void* stream) {
  if (dtype == 0)
    return launch<float, kLinear>(h, nullptr, wd, nullptr, grp_slot,
                                  grp_start, grp_count, y, f, d, groups,
                                  stream);
  if (dtype == 1)
    return launch_tc<kLinear>(h, nullptr, wd, nullptr, grp_slot, grp_start,
                              grp_count, y, f, d, slots, groups, rows,
                              stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The C interface's version: 2 since the entry points take the pool size
// (the weights' tensor maps need it) and the row count (which picks the
// block shape); tools/moe_ab.py calls older builds without them.
extern "C" int cache_moe_interface() { return 2; }

extern "C" const char* cache_moe_error_string(int code) {
  return hopper::error_string(code);
}
