// Mamba2 chunked SSD scan (state-space dual, single B/C group) for Hopper
// (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan.py::_ssd_kernel
// (ssd_scan.py:26, pallas_call at ssd_scan.py:81).  It computes what the
// plain version repro_torch/kernels/ref.py::ssd_ref computes, all maths in
// f32, for x [b, s, h, p], dt [b, s, h], A [h], B and C [b, s, n], cut into
// chunks of Q rows (s % Q == 0, Q <= 128):
//
//   per chunk, with cum = inclusive prefix sum of dt * A over the chunk,
//   intra  y  = (C B^T o L) (dt x)       L[i][j] = exp(cum_i - cum_j), j <= i
//                                        and exactly 0 above the diagonal
//   inter  y += exp(cum_i) * (C S)       S = the state before the chunk
//   carry  S  = S exp(cum_last) + (B exp(cum_last - cum))^T (dt x)
//
// and writes y in x's dtype and, unlike the TPU kernel, the final state
// [b, h, p, n] f32 (the layout of ssd_ref), so that a prefill takes both the
// layer's output and its recurrent state from one launch.  The state starts
// at zero, as every prefill's does.
//
// Parallelism.  The TPU kernel walks a (b, h, chunk) grid with the chunk
// axis in order and the [n, p] state in VMEM scratch.  Blocks of a CUDA grid
// run in no order, so here the chunk axis is a loop inside the block.
// Columns of p are independent (y[:, p] reads only x[:, p] and S[:, p]), so
// the grid is (p tiles of 32, h, b): at mamba2-780m's 48 heads x 64 and
// b = 1 that is 96 blocks, one wave on 132 SMs.  Each block keeps its
// [n, 32] state in shared memory (167 KB in all at Q = n = 128, so one block
// per SM).
//
// C B^T does not depend on the head or the column, so a first small kernel
// computes it once per (b, chunk) into a [b, s/Q, Q, Q] f32 scratch buffer
// (L2-resident), and every block of the scan reads it instead of
// recomputing Q^2 n products per head and tile.
//
// Bound.  The operations the bound counts are those of the per-head
// algorithm, b h (s/Q) 2 (Q^2 n + Q^2 p + 2 Q n p), against the bytes of x,
// y, dt, B, C and the state; at the served shapes the two are about even
// (at s = 2048, 8.1 GFLOP and 28 MB: ~8 us each).  This version computes on
// the CUDA cores in f32 FMA (the TPU kernel's f32 products have no
// tensor-core counterpart without TF32 rounding), with operands in shared
// memory.  What it does about the cost it pays instead:
//   * 1024 threads per block (32 warps per SM), one chunk row and four
//     columns each: with a quarter of that, the warps stalled on their
//     own shared-memory loads (PERF.md);
//   * one 16-byte load brings four columns of dt x or of the state for
//     each operand of C B^T o L, C or B, and a row's product stops at the
//     diagonal;
//   * every staging loop keeps eight global loads in flight per thread;
//   * C and then B share one buffer, which keeps the block within the
//     shared memory of one SM at a 32-column tile.
// Tensor cores, TMA loads and overlapping a chunk's loads with the previous
// chunk's products are later work; PERF.md has its time against the bound.
//
// C interface (bound with ctypes): every pointer is a device pointer, the
// stream is the caller's current stream, nothing is allocated here (the
// wrapper passes the C B^T scratch), and the entry point returns the first
// cudaError_t of its two launches (0 = launched).

#include <cstddef>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxQ = 128;
constexpr int kMaxN = 128;
constexpr int kTile = 32;                    // columns of p per scan block
constexpr int kQuads = kTile / 4;            // each thread owns 4 columns
constexpr int kThreads = kQuads * kMaxQ;     // and one row: 1024 threads
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 8;                   // global loads in flight
constexpr int kCbThreads = 256;              // C B^T pre-pass: 16 x 16
constexpr int kCbRows = 32;                  // C B^T rows per pre-pass block

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Copies the [rows][width] matrix src (width <= 128) as f32 into dst with
// row pitch `pitch`: each warp takes two rows at a time, a lane four columns
// of each, so each thread keeps kUnroll = 8 independent loads in flight (a
// block has too few warps to hide the latency of one load at a time).
template <typename T>
__device__ __forceinline__ void stage(const T* __restrict__ src, int rows,
                                      int width, int pitch,
                                      float* __restrict__ dst) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int r0 = 2 * warp; r0 < rows; r0 += 2 * kWarps) {
    float v[2][4];
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int r = r0 + a, col = lane + 32 * u;
        v[a][u] = r < rows && col < width
                      ? to_f(src[static_cast<size_t>(r) * width + col])
                      : 0.f;
      }
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int r = r0 + a, col = lane + 32 * u;
        if (r < rows && col < width) dst[r * pitch + col] = v[a][u];
      }
  }
}

// cb[b][c][i][j] = sum_k C[b, cQ + i, k] * B[b, cQ + j, k] in f32 for the
// rows i of one kCbRows slice of chunk c and every j < Q (the scan reads
// only j <= i).  Grid (s/Q, b, ceil(Q / kCbRows)); thread (ty, tx) of
// 16 x 16 owns rows ty + 16a (a < 2) and columns tx + 16e (e < 8).
template <typename T>
__global__ void __launch_bounds__(kCbThreads)
    ssd_cb(const T* __restrict__ Bm, const T* __restrict__ Cm,
           float* __restrict__ cb, int S, int N, int Q) {
  constexpr int kA = kCbRows / 16, kE = kMaxQ / 16;
  __shared__ float cs[kCbRows][33];
  __shared__ float bs[kMaxQ][33];
  const int c = blockIdx.x, b = blockIdx.y, i0 = blockIdx.z * kCbRows;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const size_t row0 = static_cast<size_t>(b) * S + static_cast<size_t>(c) * Q;
  float acc[kA][kE];
#pragma unroll
  for (int a = 0; a < kA; ++a)
#pragma unroll
    for (int e = 0; e < kE; ++e) acc[a][e] = 0.f;
  for (int k0 = 0; k0 < N; k0 += 32) {
    // (kCbRows + kMaxQ) x 32 values, kUnroll loads in flight per thread
    constexpr int kCount = (kCbRows + kMaxQ) * 32;
    for (int e0 = threadIdx.x; e0 < kCount; e0 += kCbThreads * kUnroll) {
      float v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int e = e0 + u * kCbThreads, r = e / 32, k = e % 32;
        const bool is_c = r < kCbRows;
        const int row = is_c ? i0 + r : r - kCbRows;
        const bool in = e < kCount && row < Q && k0 + k < N;
        const size_t at = (row0 + row) * N + k0 + k;
        v[u] = in ? to_f(is_c ? Cm[at] : Bm[at]) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int e = e0 + u * kCbThreads, r = e / 32, k = e % 32;
        if (e < kCount) {
          if (r < kCbRows)
            cs[r][k] = v[u];
          else
            bs[r - kCbRows][k] = v[u];
        }
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < 32; ++k) {
      float cv[kA], bv[kE];
#pragma unroll
      for (int a = 0; a < kA; ++a) cv[a] = cs[ty + 16 * a][k];
#pragma unroll
      for (int e = 0; e < kE; ++e) bv[e] = bs[tx + 16 * e][k];
#pragma unroll
      for (int a = 0; a < kA; ++a)
#pragma unroll
        for (int e = 0; e < kE; ++e) acc[a][e] = fmaf(cv[a], bv[e], acc[a][e]);
    }
    __syncthreads();
  }
  float* out = cb + (static_cast<size_t>(b) * gridDim.x + c) * Q * Q;
#pragma unroll
  for (int a = 0; a < kA; ++a) {
    const int i = i0 + ty + 16 * a;
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      const int j = tx + 16 * e;
      if (i < Q && j < Q) out[i * Q + j] = acc[a][e];
    }
  }
}

// Shared memory of one scan block, in floats: C B^T o L [Q][Q+1], then C
// and later B in one [Q][N+1] buffer, then (16-byte aligned) x and dt x
// [Q][kTile], the state [N][kTile], and dt, cum, exp(cum),
// exp(cum_last - cum) [Q] each.
__host__ __device__ inline int scan_x_offset(int Q, int N) {
  return (Q * (Q + 1) + Q * (N + 1) + 3) & ~3;
}

size_t scan_smem_bytes(int Q, int N) {
  const size_t f = static_cast<size_t>(scan_x_offset(Q, N)) +
                   static_cast<size_t>(Q + N) * kTile + 4 * static_cast<size_t>(Q);
  return f * sizeof(float);
}

// Grid (ceil(P / kTile), H, Bsz), kThreads threads.  Thread t owns columns
// 4 (t % kQuads) to 4 (t % kQuads) + 3 of the tile and row t / kQuads: that
// chunk row of y and that row of the state.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_scan(const T* __restrict__ x, const float* __restrict__ dt,
             const float* __restrict__ A, const T* __restrict__ Bm,
             const T* __restrict__ Cm, const float* __restrict__ cb,
             T* __restrict__ y, float* __restrict__ final_state, int S,
             int H, int P, int N, int Q) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float warp_sum[kWarps];
  const int QP = Q + 1, NP = N + 1;
  float* Ms = smem;                  // C B^T, then C B^T o L (j <= i)
  float* Ws = Ms + Q * QP;           // C, then B
  float* Xs = smem + scan_x_offset(Q, N);   // x, then dt * x
  float* Ss = Xs + Q * kTile;        // the state, [n][column]
  float* dts = Ss + N * kTile;
  float* cum = dts + Q;
  float* ecum = cum + Q;             // exp(cum_i)
  float* wend = ecum + Q;            // exp(cum_last - cum_i)

  const int p0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, c0 = 4 * (tid % kQuads), row = tid / kQuads;
  const int lane = tid % 32, warp = tid / 32;
  const float a_h = A[h];
  const int nc = S / Q;
  const size_t bh = static_cast<size_t>(b) * H + h;

  for (int e = tid; e < N * kTile; e += kThreads) Ss[e] = 0.f;

  for (int c = 0; c < nc; ++c) {
    const size_t t0 = static_cast<size_t>(b) * S + static_cast<size_t>(c) * Q;
    __syncthreads();                 // the previous chunk's reads are done
    for (int i = tid; i < Q; i += kThreads) dts[i] = dt[(t0 + i) * H + h];
    stage(Cm + t0 * N, Q, N, NP, Ws);
    stage(cb + (static_cast<size_t>(b) * nc + c) * Q * Q, Q, Q, QP, Ms);
    for (int e = tid; e < Q * kTile; e += kThreads) {
      const int i = e / kTile, cc = e % kTile;
      Xs[e] = p0 + cc < P ? to_f(x[((t0 + i) * H + h) * P + p0 + cc]) : 0.f;
    }
    __syncthreads();

    // inclusive prefix sum of dt * A: a shuffle scan per warp, then each
    // row adds the totals of the warps before it (Q <= 128: warps 0-3)
    float v = tid < Q ? dts[tid] * a_h : 0.f;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += u;
    }
    if (lane == 31) warp_sum[warp] = v;
    __syncthreads();
    if (tid < Q) {
      for (int w = 0; w < warp; ++w) v += warp_sum[w];
      cum[tid] = v;
    }
    __syncthreads();
    const float clast = cum[Q - 1];
    if (tid < Q) {
      ecum[tid] = expf(cum[tid]);
      wend[tid] = expf(clast - cum[tid]);
    }
    // L = exp(cum_i - cum_j) on and below the diagonal, the only part read
    for (int i = warp; i < Q; i += kWarps)
      for (int j = lane; j <= i; j += 32) Ms[i * QP + j] *= expf(cum[i] - cum[j]);
    for (int e = tid; e < Q * kTile; e += kThreads) Xs[e] *= dts[e / kTile];
    __syncthreads();

    // y = (C B^T o L)(dt x) + exp(cum) (C S) for this thread's row and its
    // four columns; the product stops at the diagonal
    if (row < Q) {
      float4 yd = make_float4(0.f, 0.f, 0.f, 0.f), yo = yd;
      const float* mrow = Ms + row * QP;
      for (int j = 0; j <= row; ++j) {
        const float m = mrow[j];
        const float4 xv = *reinterpret_cast<const float4*>(Xs + j * kTile + c0);
        yd.x = fmaf(m, xv.x, yd.x);
        yd.y = fmaf(m, xv.y, yd.y);
        yd.z = fmaf(m, xv.z, yd.z);
        yd.w = fmaf(m, xv.w, yd.w);
      }
      const float* crow = Ws + row * NP;
      for (int nn = 0; nn < N; ++nn) {
        const float cv = crow[nn];
        const float4 sv = *reinterpret_cast<const float4*>(Ss + nn * kTile + c0);
        yo.x = fmaf(cv, sv.x, yo.x);
        yo.y = fmaf(cv, sv.y, yo.y);
        yo.z = fmaf(cv, sv.z, yo.z);
        yo.w = fmaf(cv, sv.w, yo.w);
      }
      const float e = ecum[row];
      const float out[4] = {yd.x + e * yo.x, yd.y + e * yo.y, yd.z + e * yo.z,
                            yd.w + e * yo.w};
      T* yrow = y + ((t0 + row) * H + h) * P + p0 + c0;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (p0 + c0 + q < P) yrow[q] = from_f<T>(out[q]);
    }
    __syncthreads();                 // every read of C and of S is done
    stage(Bm + t0 * N, Q, N, NP, Ws);
    __syncthreads();

    // S = S exp(cum_last) + (B exp(cum_last - cum))^T (dt x) for this
    // thread's state row; a padded row (dt = 0) adds nothing and leaves
    // cum, hence the decay, unchanged
    if (row < N) {
      float4 sa = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int i = 0; i < Q; ++i) {
        const float bw = Ws[i * NP + row] * wend[i];
        const float4 xv = *reinterpret_cast<const float4*>(Xs + i * kTile + c0);
        sa.x = fmaf(bw, xv.x, sa.x);
        sa.y = fmaf(bw, xv.y, sa.y);
        sa.z = fmaf(bw, xv.z, sa.z);
        sa.w = fmaf(bw, xv.w, sa.w);
      }
      const float elast = expf(clast);
      float4* s = reinterpret_cast<float4*>(Ss + row * kTile + c0);
      const float4 old = *s;
      *s = make_float4(old.x * elast + sa.x, old.y * elast + sa.y,
                       old.z * elast + sa.z, old.w * elast + sa.w);
    }
  }
  __syncthreads();
  for (int e = tid; e < N * kTile; e += kThreads) {
    const int cc = e / N, nn = e % N;
    if (p0 + cc < P)
      final_state[(bh * P + p0 + cc) * N + nn] = Ss[nn * kTile + cc];
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, void* cb, void* y, void* final_state, int Bsz,
           int S, int H, int P, int N, int Q, void* stream) {
  if (Q < 1 || Q > kMaxQ || N < 1 || N > kMaxN || S % Q || P < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto strm = static_cast<cudaStream_t>(stream);
  const dim3 cb_grid(S / Q, Bsz, (Q + kCbRows - 1) / kCbRows);
  ssd_cb<T><<<cb_grid, kCbThreads, 0, strm>>>(
      static_cast<const T*>(Bm), static_cast<const T*>(Cm),
      static_cast<float*>(cb), S, N, Q);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t smem = scan_smem_bytes(Q, N);
  e = cudaFuncSetAttribute(ssd_scan<T>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((P + kTile - 1) / kTile, H, Bsz);
  ssd_scan<T><<<grid, kThreads, smem, strm>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const float*>(cb),
      static_cast<T*>(y), static_cast<float*>(final_state), S, H, P, N, Q);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (of x, B, C and y).  x [Bsz, S, H, P],
// dt [Bsz, S, H] f32, A [H] f32, B/C [Bsz, S, N], cb scratch
// [Bsz, S/Q, Q, Q] f32, y like x, final_state [Bsz, H, P, N] f32; all
// contiguous.  1 <= Q <= 128, S % Q == 0,
// 1 <= N <= 128.
extern "C" int ssd_scan_fwd(int dtype, const void* x, const void* dt,
                            const void* A, const void* Bm, const void* Cm,
                            void* cb, void* y, void* final_state, int Bsz,
                            int S, int H, int P, int N, int Q,
                            void* stream) {
  if (Bsz <= 0 || S <= 0 || H <= 0) return 0;
  if (dtype == 0)
    return launch<float>(x, dt, A, Bm, Cm, cb, y, final_state, Bsz, S, H, P,
                         N, Q, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dt, A, Bm, Cm, cb, y, final_state, Bsz,
                                 S, H, P, N, Q, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
