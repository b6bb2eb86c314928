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
// are one template, slot_ffn, with the epilogue as its parameter.  The weights are
// read straight out of the [S, d, f] / [S, f, d] slot pool: nothing gathers
// or copies a weight row.  Groups with no rows exit at once, so misses and
// unoccupied slots cost nothing.
//
// Bound.  A verify block has T = draft_len + 1 = 5 tokens and top-2 routing,
// so each touched slot sees at most a handful of rows: the work is a few
// matrix-vector products, and it is the weight bytes that bound it:
//   bytes = M_touched * 3 * d * f * 2   (bf16)
// At d = 4096, f = 14336 with all 8 experts of a layer touched that is
// 2.82 GB, 0.84 ms per layer at the H100's 3.35 TB/s (gelu experts read two
// of the three matrices: 2 * d * f * 2 per touched slot).  The operations,
// 2 * rows * 3 * d * f, are ~1 % of the bf16 tensor-core rate at these rows.
//
// How the design answers it.
//   * Neighbouring threads own neighbouring output columns and load them as
//     one 16-byte vector, so every warp reads whole contiguous weight rows.
//   * Each weight element is loaded once per (slot, column tile) and applied
//     to all of that slot's rows (up to kRows per pass, accumulators in
//     registers); the rows themselves sit in shared memory as f32.
//   * The reduction axis is split over the block's 8 warps in a fixed pattern
//     (chunks of kChunk, each warp a fixed kChunk / 8 slice), and the warps'
//     partial sums are added in warp order.  That order depends on d and f
//     alone, never on T, M or the number of rows: every output row is
//     bit-identical however many other rows share the launch (batch
//     invariance, which lossless batched verify rests on).  No split-K
//     across blocks, no atomics.
//   * No tensor cores, TMA or wgmma yet: at these row counts the CUDA cores
//     keep up with the memory; a later PR can pipeline the loads with TMA.
//
// C interface (bound with ctypes): every pointer is a device pointer, the
// stream is the caller's current stream, nothing is allocated here, and each
// entry point returns the launch's cudaError_t (0 = launched).

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

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

template <>
struct Traits<__nv_bfloat16> {
  static constexpr int kVec = 8;         // 16 bytes
  __device__ static float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
  __device__ static __nv_bfloat16 from_f(float v) { return __float2bfloat16(v); }
  __device__ static void load(const __nv_bfloat16* p, float (&v)[8]) {
    const uint4 a = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float2 f = __bfloat1622float2(h[q]);
      v[2 * q] = f.x;
      v[2 * q + 1] = f.y;
    }
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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  x [T, d], row_tok [P], wg/wu [S, d, f],
// grp_* [groups] -> h [P, f].
extern "C" int cache_moe_gate_up(int dtype, const void* x, const void* row_tok,
                                 const void* wg, const void* wu,
                                 const void* grp_slot, const void* grp_start,
                                 const void* grp_count, void* h, int d, int f,
                                 int groups, void* stream) {
  if (dtype == 0)
    return launch<float, kSwiglu>(x, row_tok, wg, wu, grp_slot, grp_start,
                                  grp_count, h, d, f, groups, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16, kSwiglu>(x, row_tok, wg, wu, grp_slot,
                                          grp_start, grp_count, h, d, f,
                                          groups, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Gelu experts.  x [T, d], row_tok [P], wu [S, d, f], grp_* [groups] -> h [P, f].
extern "C" int cache_moe_up_gelu(int dtype, const void* x, const void* row_tok,
                                 const void* wu, const void* grp_slot,
                                 const void* grp_start, const void* grp_count,
                                 void* h, int d, int f, int groups,
                                 void* stream) {
  if (dtype == 0)
    return launch<float, kGelu>(x, row_tok, wu, nullptr, grp_slot, grp_start,
                                grp_count, h, d, f, groups, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16, kGelu>(x, row_tok, wu, nullptr, grp_slot,
                                        grp_start, grp_count, h, d, f, groups,
                                        stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// h [P, f], wd [S, f, d], grp_* [groups] -> y [P, d].
extern "C" int cache_moe_down(int dtype, const void* h, const void* wd,
                              const void* grp_slot, const void* grp_start,
                              const void* grp_count, void* y, int f, int d,
                              int groups, void* stream) {
  if (dtype == 0)
    return launch<float, kLinear>(h, nullptr, wd, nullptr, grp_slot,
                                  grp_start, grp_count, y, f, d, groups,
                                  stream);
  if (dtype == 1)
    return launch<__nv_bfloat16, kLinear>(h, nullptr, wd, nullptr, grp_slot,
                                          grp_start, grp_count, y, f, d,
                                          groups, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* cache_moe_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
