// Mamba2 chunked SSD scan (state-space dual, single B/C group) for Hopper
// (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan.py::_ssd_kernel
// (ssd_scan.py:26, pallas_call at ssd_scan.py:81).  It computes what the
// plain version repro_torch/kernels/ref.py::ssd_ref computes, for x
// [b, s, h, p], dt [b, s, h] f32, A [h] f32, B and C [b, s, n], cut into
// chunks of Q rows (s % Q == 0, Q <= 128, n <= 128), from a zero state:
//
//   per chunk c and head, with cum = inclusive prefix sum of dt * A over
//   the chunk and S_{c-1} the state before the chunk,
//   y   = (C B^T o L) diag(dt) X + diag(exp(cum)) C S_{c-1}^T
//                      L[i][j] = exp(cum_i - cum_j) for j <= i, exactly 0
//                      above the diagonal (never exp(cum_i) exp(-cum_j),
//                      which overflows f32 at a slow chunk's sums; below
//                      the diagonal 16 x 16 tiles it is exp(cum_i - c)
//                      exp(c - cum_j), c the cum of the tile's last
//                      column, both factors <= 1)
//   S_c = S_{c-1} exp(cum_last) + X^T diag(dt exp(cum_last - cum)) B
//
// and writes y in x's dtype and the final state [b, h, p, n] f32 (the
// layout of ssd_ref), so that a prefill takes both from one call.
//
// Structure (arXiv:2405.21060, section 6): only the carry of the state from
// chunk to chunk is sequential, so a call is three launches whose grids and
// blocks depend on the shapes alone (a CUDA graph can capture the call):
//   1. ssd_state_*: one block per (chunk, p tile, head) computes cum (kept
//      in a [b, h, s] f32 scratch) and the chunk's own end state
//      X^T diag(w) B, w = dt exp(cum_last - cum), into a [b, s/Q, h, p, n]
//      f32 scratch (6.3 MB at mamba2-780m's widths and s = 512: it stays in
//      L2);
//   2. ssd_state_pass: one thread per four state elements walks the chunks
//      in order, writing over each chunk's end state the state before it
//      (S = S exp(cum_last) + end state; for bf16 each element's hi and lo
//      bf16 parts in its 4 bytes), and writes the final state;
//   3. ssd_scan_*: one block per (chunk, p tile, head) computes y.  C B^T
//      is made inside the block, 16 columns at a time, and never goes
//      through device memory.
// Both scratch buffers come from the wrapper (torch.empty); nothing is
// allocated here, and no sum uses atomics: two calls give the same bits.
//
// bf16 (every served SSD model): the products run on the tensor cores with
// f32 accumulators.  x, B and C enter exactly.  Each f32 factor (the
// weighted x w, C B^T o L o dt, the carried state) is split into bf16
// hi + lo, v - hi rounded, and multiplied twice into the same accumulator:
// ~2^-16 of the factor, against the state's 1e-4 (the pass splits the
// carried state once).
//   * The end state is one wgmma m64n64k16 chain per warpgroup: A = (x w)^T
//     hi and lo from registers (ldmatrix, then scaled and split), B from a
//     128-byte-swizzled tile.
//   * The scan runs on mma.sync m16n8k16, each warp on its own 16 rows: its
//     C rows stay in registers as A fragments for C S^T and C B^T, and
//     C B^T o L o dt goes from the accumulators straight into the A
//     fragments of its product with x, as P does in flash attention; a
//     warp stops at its diagonal tile.  A wgmma version (C S^T, C B^T and
//     the product with x by warpgroup, pipelined) was slower: a
//     warpgroup's four warps wait for each other at every 16 columns, and
//     the split state needs one more pass through shared memory (PERF.md).
// Tiles come in by cp.async (16-byte pieces, zeros past the edge; ragged
// tiles, Q 77, p 8, n 16, are padded with zeros in shared memory): in the
// scan C and the carried state first, so that C S^T runs while B (in C's
// place) and x are still in flight.  Rows that 16 bytes do not cover (n or
// p not a multiple of 16 bytes, an unaligned pointer) are copied element by
// element.
//
// f32 (checked on the card, served by no model): the same three launches,
// with the products as f32 FMA on the CUDA cores (tensor cores would round
// to TF32).
//
// Bound.  The bound counts the per-head algorithm's operations,
// b h (s/Q) 2 (Q^2 n + Q^2 p + 2 Q n p), at the bf16 tensor rate against
// x, y, dt, B, C and the final state moved once: at mamba2-780m's widths
// and s = 512, 2.46 us, set by the bytes.  PERF.md has the times.
//
// C interface (bound with ctypes): every pointer is a device pointer, the
// stream is the caller's current stream, and the entry point returns the
// first cudaError_t of its launches (0 = launched).

#include <cstddef>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using hopper::cp_async_16;
using hopper::smem_addr;
using hopper::wgmma_rs_n64;

constexpr int kMaxQ = 128;
constexpr int kMaxN = 128;
constexpr int kPT = 64;                // columns of p per block
constexpr int kThreads = 256;          // 8 warps
constexpr int kPassThreads = 256;

// flags of a call: which tiles may be copied in 16-byte pieces
constexpr int kVecX = 1, kVecBC = 2, kVecS = 4;

__host__ __device__ constexpr int pad16(int v) { return (v + 15) & ~15; }

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most kPending committed groups of this thread are in flight.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() {
  return 0.f;
}
template <>
__device__ __forceinline__ bf16 zero<bf16>() {
  return __float2bfloat16(0.f);
}
template <>
__device__ __forceinline__ uint32_t zero<uint32_t>() {
  return 0u;
}

// The [rows_pad x cols_pad] tile at dst (row pitch `pitch` elements) from
// src (row r at src + r * stride): element (r, c) for r < rows, c < cols,
// zero elsewhere.  cols_pad is a multiple of 16 bytes.  With `vec` (rows
// and cols in whole 16-byte pieces, aligned) by cp.async, which the caller
// commits and waits for; else element by element.
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, int pitch, const T* src,
                                          size_t stride, int rows, int cols,
                                          int rows_pad, int cols_pad,
                                          bool vec) {
  constexpr int E = 16 / sizeof(T);
  const int pieces = cols_pad / E;
  for (int e = threadIdx.x; e < rows_pad * pieces; e += blockDim.x) {
    const int r = e / pieces, c = (e % pieces) * E;
    T* d = dst + r * pitch + c;
    const bool in = r < rows && c < cols;
    if (vec) {
      cp_async_16(smem_addr(d), in ? src + r * stride + c : src,
                  in ? 16 : 0);
    } else {
#pragma unroll
      for (int u = 0; u < E; ++u)
        d[u] = in && c + u < cols ? src[r * stride + c + u] : zero<T>();
    }
  }
}

// dts[l] = dt of row l of the chunk for this head and cum[l] the inclusive
// prefix sum of dt * a, for l < pad16(Q); dt is 0 past Q, so cum stays at
// cum[Q - 1] there.  A shuffle scan in each of warps 0-3, then each row
// adds the totals of the warps before it.  Ends with a barrier.
__device__ __forceinline__ void chunk_cumsum(const float* __restrict__ dtc,
                                             int H, float a, int Q,
                                             float* dts, float* cum,
                                             float* tot) {
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const float d = t < Q ? dtc[static_cast<size_t>(t) * H] : 0.f;
  float v = d * a;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += u;
  }
  if (lane == 31 && warp < kMaxQ / 32) tot[warp] = v;
  __syncthreads();
  if (t < kMaxQ) {
    for (int w = 0; w < warp; ++w) v += tot[w];
    dts[t] = d;
    cum[t] = v;
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// tensor-core pieces (bf16)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
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

// c[16 x 8] += a[16 x 16] b[16 x 8].  Lane t = 4 g + i holds a's (row g,
// cols 2i, 2i+1), (g + 8, 2i..), (g, 2i + 8..), (g + 8, 2i + 8..); b's
// (rows 2i, 2i+1, col g), (2i + 8.., g); c's (g, 2i..) and (g + 8, 2i..).
// Not volatile: a product reads registers only, so the compiler may
// interleave independent ones.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (v0, v1) as bf16 hi + lo pairs: hi = bf16(v), lo = bf16(v - hi).
__device__ __forceinline__ void split(float v0, float v1, uint32_t& hi,
                                      uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(v0 - __low2float(h),
                                    v1 - __high2float(h)));
}

// Shared memory of the bf16 kernels, in bytes.  Padded row pitches are 8
// elements (16 bytes) past the tile, so that ldmatrix's eight rows and the
// carried state's 8-byte reads fall in distinct banks.
struct StateSmem {
  int xp, b, x, f;                   // x's pitch, offsets (bytes)
  int bytes;
  __host__ __device__ StateSmem(int Q, int) {
    const int Qp = pad16(Q);
    xp = kPT + 8;
    b = 0;                           // B: two 64-column boxes, 1024-aligned
    x = b + 2 * Qp * 128;
    f = x + Qp * xp * 2;
    bytes = 1024 + f + (3 * kMaxQ + 4) * 4;   // + the alignment
  }
};
// The scan's C tile, once its rows are in registers, makes room for B:
// 89 KB at Q = n = 128, two blocks per SM.  The carried state comes as
// (hi, lo) bf16 pairs, one 4-byte word an element.
struct ScanSmem {
  int cp, xp, sp, c, x, s, f;
  int bytes;
  __host__ __device__ ScanSmem(int Q, int N) {
    const int Qp = pad16(Q), Np = pad16(N);
    cp = Np + 8;
    xp = kPT + 8;
    sp = Np + 8;
    c = 0;
    x = c + Qp * cp * 2;
    s = x + Qp * xp * 2;
    f = s + kPT * sp * 4;
    bytes = f + 3 * kMaxQ * 4;
  }
};

// B [rows x cols] of bf16 into the canonical 128-byte-swizzled MN-major
// layout wgmma reads: 64-column boxes of rows_pad rows x 128 bytes, the
// 16-byte piece c of row r at piece c ^ (r % 8); zeros past rows and cols,
// up to cols_pad (a multiple of 64).  With `vec` by cp.async, which the
// caller commits and waits for; else element by element.
__device__ __forceinline__ void load_tile_sw128(unsigned char* dst,
                                                const bf16* src,
                                                size_t stride, int rows,
                                                int cols, int rows_pad,
                                                int cols_pad, bool vec) {
  const int pieces = cols_pad / 8;
  for (int e = threadIdx.x; e < rows_pad * pieces; e += blockDim.x) {
    const int r = e / pieces, pc = e % pieces, col = pc * 8;
    bf16* d = reinterpret_cast<bf16*>(
        dst + (pc / 8) * rows_pad * 128 + r * 128 +
        (((pc % 8) ^ (r % 8)) << 4));
    const bool in = r < rows && col < cols;
    if (vec) {
      cp_async_16(smem_addr(d), in ? src + r * stride + col : src,
                  in ? 16 : 0);
    } else {
#pragma unroll
      for (int u = 0; u < 8; ++u)
        d[u] = in && col + u < cols ? src[r * stride + col + u]
                                    : zero<bf16>();
    }
  }
}

// 1. The chunk's end state, bf16.  Grid (s/Q * p tiles, H, Bsz): a block
// owns 64 rows (p) and every column (n) of the state; warpgroup g the
// columns 64 g .. 64 g + 63, and its warp i the rows 16 i ..:
// states[p][n] = sum_l (x[l][p] w_l) B[l][n], the first factor hi + lo from
// registers, B from the swizzled tile, wgmma m64n64k16.
__global__ void __launch_bounds__(kThreads, 2)
    ssd_state_mma(const bf16* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ A, const bf16* __restrict__ Bm,
                  float* __restrict__ states, float* __restrict__ cum_out,
                  int S, int H, int P, int N, int Q, int flags) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + (1024 - smem_addr(smem_raw) % 1024) % 1024;
  const StateSmem L(Q, N);
  unsigned char* Bs = smem + L.b;
  bf16* Xs = reinterpret_cast<bf16*>(smem + L.x);
  float* dts = reinterpret_cast<float*>(smem + L.f);
  float* cum = dts + kMaxQ;
  float* wgt = cum + kMaxQ;
  float* tot = wgt + kMaxQ;
  const int Qp = pad16(Q), Np = pad16(N), Nb = (N + 63) & ~63;
  const int ptiles = (P + kPT - 1) / kPT, nc = S / Q;
  const int c = blockIdx.x / ptiles, p0 = (blockIdx.x % ptiles) * kPT;
  const int h = blockIdx.y, b = blockIdx.z;
  const int pv = min(kPT, P - p0);
  const size_t t0 = static_cast<size_t>(b) * S + static_cast<size_t>(c) * Q;

  load_tile(Xs, L.xp, x + (t0 * H + h) * P + p0, static_cast<size_t>(H) * P,
            Q, pv, Qp, kPT, flags & kVecX);
  load_tile_sw128(Bs, Bm + t0 * N, N, Q, N, Qp, Nb, flags & kVecBC);
  cp_async_commit();
  chunk_cumsum(dt + t0 * H + h, H, A[h], Q, dts, cum, tot);
  const int t = threadIdx.x;
  const float clast = cum[Q - 1];
  if (t < Q && p0 == 0)
    cum_out[(static_cast<size_t>(b) * H + h) * S + static_cast<size_t>(c) * Q +
            t] = cum[t];
  if (t < kMaxQ) wgt[t] = t < Q ? dts[t] * expf(clast - cum[t]) : 0.f;
  cp_async_wait<0>();
  hopper::fence_proxy_async();       // B, written by cp.async, read by wgmma
  __syncthreads();

  const int lane = t % 32, warp = t / 32, g = lane / 4, i4 = lane % 4;
  const int wi = warp % 4, wg = warp / 4;
  if (64 * wg >= Np) return;         // the whole warpgroup
  // A = (x o w)^T [16 p x 16 l] from the [l][p] tile, transposed, as hi and
  // lo fragments for every 16 rows of l
  uint32_t ahi[kMaxQ / 16][4], alo[kMaxQ / 16][4];
#pragma unroll
  for (int ks = 0; ks < kMaxQ / 16; ++ks) {
    const int k0 = 16 * ks;
    if (k0 >= Qp) continue;
    uint32_t xa[4];
    ldsm_x4_trans(xa, smem_addr(Xs + (k0 + (lane & 7) + (lane >> 4) * 8) *
                                         L.xp +
                                16 * wi + ((lane >> 3) & 1) * 8));
    const float w0 = wgt[k0 + 2 * i4], w1 = wgt[k0 + 2 * i4 + 1];
    const float w2 = wgt[k0 + 8 + 2 * i4], w3 = wgt[k0 + 9 + 2 * i4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const __nv_bfloat162 v =
          *reinterpret_cast<const __nv_bfloat162*>(&xa[r]);
      const float wa = r < 2 ? w0 : w2, wb = r < 2 ? w1 : w3;
      split(__low2float(v) * wa, __high2float(v) * wb, ahi[ks][r],
            alo[ks][r]);
    }
  }
  float acc[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) acc[e] = 0.f;
  const uint64_t bd = hopper::gmma_desc(smem_addr(Bs + wg * Qp * 128),
                                        Qp * 128, 1024, 1);
  hopper::fence_regs(ahi);           // every A fragment is made first
  hopper::fence_regs(alo);
  hopper::wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < kMaxQ / 16; ++ks) {
    if (16 * ks >= Qp) continue;
    const uint64_t bk = bd + ((ks * 16 * 128) >> 4);   // 16 rows of l on
    wgmma_rs_n64(acc, ahi[ks], bk);
    wgmma_rs_n64(acc, alo[ks], bk);
  }
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  hopper::fence_regs(acc);           // read after the wait, and the A
  hopper::fence_regs(ahi);           // registers kept until it
  hopper::fence_regs(alo);

  float* out = states + ((static_cast<size_t>(b) * nc + c) * H + h) *
                            static_cast<size_t>(P) * N;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int n = 64 * wg + 8 * nt + 2 * i4;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int pr = 16 * wi + g + 8 * half;
      if (pr >= pv) continue;
      float* row = out + static_cast<size_t>(p0 + pr) * N;
      const float v0 = acc[4 * nt + 2 * half], v1 = acc[4 * nt + 2 * half + 1];
      if (n + 1 < N && N % 2 == 0) {
        *reinterpret_cast<float2*>(row + n) = make_float2(v0, v1);
      } else {
        if (n < N) row[n] = v0;
        if (n + 1 < N) row[n + 1] = v1;
      }
    }
  }
}

// 3. y, bf16.  Grid (s/Q * p tiles, H, Bsz).  Warp w owns chunk rows
// 16 w .. 16 w + 15 and the tile's 64 columns of p:
//   acc  = exp(cum_i) (C S^T)        (chunk 0: S = 0, skipped), while B
//                                    comes in where C was
//   acc += (C B^T o L o dt) x        16 columns of C B^T at a time, up to
//                                    the warp's diagonal tile
__global__ void __launch_bounds__(kThreads, 2)
    ssd_scan_mma(const bf16* __restrict__ x, const float* __restrict__ dt,
                 const bf16* __restrict__ Bm, const bf16* __restrict__ Cm,
                 const uint32_t* __restrict__ prev,
                 const float* __restrict__ cum_in, bf16* __restrict__ y,
                 int S, int H, int P, int N, int Q, int flags) {
  extern __shared__ __align__(16) unsigned char smem[];
  const ScanSmem L(Q, N);
  bf16* Cs = reinterpret_cast<bf16*>(smem + L.c);
  bf16* Bs = Cs;                     // once C is in registers
  bf16* Xs = reinterpret_cast<bf16*>(smem + L.x);
  uint32_t* Sp = reinterpret_cast<uint32_t*>(smem + L.s);
  float* dts = reinterpret_cast<float*>(smem + L.f);
  float* cums = dts + kMaxQ;
  float* bds = cums + kMaxQ;
  const int Qp = pad16(Q), Np = pad16(N);
  const int ptiles = (P + kPT - 1) / kPT, nc = S / Q;
  const int c = blockIdx.x / ptiles, p0 = (blockIdx.x % ptiles) * kPT;
  const int h = blockIdx.y, b = blockIdx.z;
  const int pv = min(kPT, P - p0);
  const size_t t0 = static_cast<size_t>(b) * S + static_cast<size_t>(c) * Q;

  // C and the carried state first, then x, then (in C's place) B
  load_tile(Cs, L.cp, Cm + t0 * N, N, Q, N, Qp, Np, flags & kVecBC);
  if (c > 0)
    load_tile(Sp, L.sp,
              prev + ((static_cast<size_t>(b) * nc + c) * H + h) *
                         static_cast<size_t>(P) * N +
                  static_cast<size_t>(p0) * N,
              N, pv, N, kPT, Np, flags & kVecS);
  cp_async_commit();
  load_tile(Xs, L.xp, x + (t0 * H + h) * P + p0, static_cast<size_t>(H) * P,
            Q, pv, Qp, kPT, flags & kVecX);
  cp_async_commit();
  const int t = threadIdx.x;
  if (t < kMaxQ) {
    const float* cq = cum_in + (static_cast<size_t>(b) * H + h) * S +
                      static_cast<size_t>(c) * Q;
    dts[t] = t < Q ? dt[(t0 + t) * H + h] : 0.f;
    cums[t] = cq[min(t, Q - 1)];
  }
  cp_async_wait<1>();
  __syncthreads();
  // column j's factor below the diagonal tiles: exp(c - cum_j) dt_j, c the
  // cum of the last column of j's 16-wide block (<= 1: no overflow)
  if (t < kMaxQ) bds[t] = expf(cums[t | 15] - cums[t]) * dts[t];

  const int lane = t % 32, warp = t / 32, g = lane / 4, i4 = lane % 4;
  const int i0 = 16 * warp;
  const bool active = i0 < Qp;
  uint32_t ca[kMaxN / 16][4];        // this warp's C rows, A fragments
  float acc[kPT / 8][4];
#pragma unroll
  for (int a = 0; a < kPT / 8; ++a)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[a][e] = 0.f;
  const float ci0 = cums[min(i0 + g, kMaxQ - 1)];
  const float ci1 = cums[min(i0 + g + 8, kMaxQ - 1)];
  if (active) {
#pragma unroll
    for (int ns = 0; ns < kMaxN / 16; ++ns)
      if (16 * ns < Np)
        ldsm_x4(ca[ns], smem_addr(Cs + (i0 + (lane & 15)) * L.cp + 16 * ns +
                                  (lane >> 4) * 8));
  }
  __syncthreads();                   // every warp's C rows are read
  load_tile(Bs, L.cp, Bm + t0 * N, N, Q, N, Qp, Np, flags & kVecBC);
  cp_async_commit();
  if (active) {
    if (c > 0) {
#pragma unroll
      for (int ns = 0; ns < kMaxN / 16; ++ns) {
        if (16 * ns >= Np) continue;
        // B [16 n x 8 p] = S^T: lane (g, i4) reads S[p g][n 2 i4 ..] and
        // [.. + 8], each element its (hi, lo) pair, and regroups them
        uint32_t sh[kPT / 8][2], sl[kPT / 8][2];
#pragma unroll
        for (int pt = 0; pt < kPT / 8; ++pt) {
          const uint32_t* sr = Sp + (8 * pt + g) * L.sp + 16 * ns + 2 * i4;
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            const uint2 w = *reinterpret_cast<const uint2*>(sr + 8 * k);
            sh[pt][k] = __byte_perm(w.x, w.y, 0x5410);
            sl[pt][k] = __byte_perm(w.x, w.y, 0x7632);
          }
        }
#pragma unroll
        for (int pt = 0; pt < kPT / 8; ++pt)
          if (8 * pt < pv) mma(acc[pt], ca[ns], sh[pt][0], sh[pt][1]);
#pragma unroll
        for (int pt = 0; pt < kPT / 8; ++pt)
          if (8 * pt < pv) mma(acc[pt], ca[ns], sl[pt][0], sl[pt][1]);
      }
      const float e0 = expf(ci0), e1 = expf(ci1);
#pragma unroll
      for (int pt = 0; pt < kPT / 8; ++pt) {
        acc[pt][0] *= e0;
        acc[pt][1] *= e0;
        acc[pt][2] *= e1;
        acc[pt][3] *= e1;
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  if (!active) return;

  const int r0 = i0 + g, r1 = r0 + 8;
  for (int kk = 0; kk <= warp && 16 * kk < Qp; ++kk) {
    // C B^T for columns 16 kk .. 16 kk + 15 (two n-tiles), the even and
    // the odd 16-wide slices of n summed apart: four independent chains
    float gp[2][2][4];
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int e = 0; e < 8; ++e) gp[a][e / 4][e % 4] = 0.f;
#pragma unroll
    for (int ns = 0; ns < kMaxN / 16; ++ns) {
      if (16 * ns >= Np) continue;
      uint32_t bb[4];
      ldsm_x4(bb, smem_addr(Bs + (16 * kk + (lane & 7) + (lane >> 4) * 8) *
                                     L.cp +
                            16 * ns + ((lane >> 3) & 1) * 8));
      mma(gp[ns & 1][0], ca[ns], bb[0], bb[1]);
      mma(gp[ns & 1][1], ca[ns], bb[2], bb[3]);
    }
    float gt[2][4];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      gt[e / 4][e % 4] = gp[0][e / 4][e % 4] + gp[1][e / 4][e % 4];
    // o L o dt, then hi + lo A fragments of the [16 x 16] factor
    uint32_t ahi[4], alo[4];
    if (kk < warp) {
      // below the diagonal, L = exp(cum_i - c) exp(c - cum_j) with c the
      // cum of the tile's last column: every i lies below it, every j at or
      // above it, so both factors are <= 1
      const float cl = cums[16 * kk + 15];
      const float a0 = expf(ci0 - cl), a1 = expf(ci1 - cl);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int j = 16 * kk + 8 * nt + 2 * i4;
        const float b0 = bds[j], b1 = bds[j + 1];
        split(gt[nt][0] * a0 * b0, gt[nt][1] * a0 * b1, ahi[2 * nt],
              alo[2 * nt]);
        split(gt[nt][2] * a1 * b0, gt[nt][3] * a1 * b1, ahi[2 * nt + 1],
              alo[2 * nt + 1]);
      }
    } else {
      // the diagonal tile: exp(cum_i - cum_j) element by element, and
      // exactly 0 above the diagonal
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int j = 16 * kk + 8 * nt + 2 * i4;
        const float cj0 = cums[j], cj1 = cums[j + 1];
        const float d0 = dts[j], d1 = dts[j + 1];
        const float m00 = j <= r0 ? gt[nt][0] * expf(ci0 - cj0) * d0 : 0.f;
        const float m01 =
            j + 1 <= r0 ? gt[nt][1] * expf(ci0 - cj1) * d1 : 0.f;
        const float m10 = j <= r1 ? gt[nt][2] * expf(ci1 - cj0) * d0 : 0.f;
        const float m11 =
            j + 1 <= r1 ? gt[nt][3] * expf(ci1 - cj1) * d1 : 0.f;
        split(m00, m01, ahi[2 * nt], alo[2 * nt]);
        split(m10, m11, ahi[2 * nt + 1], alo[2 * nt + 1]);
      }
    }
    // B [16 j x 16 p] from the [j][p] tile of x, transposed
    uint32_t xb[kPT / 16][4];
#pragma unroll
    for (int pp = 0; pp < kPT / 16; ++pp)
      if (16 * pp < pv)
        ldsm_x4_trans(xb[pp], smem_addr(Xs + (16 * kk + (lane & 7) +
                                              ((lane >> 3) & 1) * 8) *
                                                 L.xp +
                                        16 * pp + (lane >> 4) * 8));
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int pp = 0; pp < kPT / 16; ++pp)
        if (16 * pp < pv) {
          const uint32_t(&a)[4] = half ? alo : ahi;
          mma(acc[2 * pp], a, xb[pp][0], xb[pp][1]);
          mma(acc[2 * pp + 1], a, xb[pp][2], xb[pp][3]);
        }
  }

#pragma unroll
  for (int pt = 0; pt < kPT / 8; ++pt) {
    const int col = p0 + 8 * pt + 2 * i4;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = half ? r1 : r0;
      if (r >= Q) continue;
      bf16* row = y + ((t0 + r) * H + h) * P;
      const float v0 = acc[pt][2 * half], v1 = acc[pt][2 * half + 1];
      if (col + 1 < P && P % 2 == 0) {
        *reinterpret_cast<__nv_bfloat162*>(row + col) =
            __floats2bfloat162_rn(v0, v1);
      } else {
        if (col < P) row[col] = __float2bfloat16(v0);
        if (col + 1 < P) row[col + 1] = __float2bfloat16(v1);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// f32: the same launches, products as FMA on the CUDA cores
// ---------------------------------------------------------------------------

// Shared memory of the f32 kernels, in floats; pitches are multiples of 4
// (16-byte rows for cp.async).
struct StateSmemF {
  int xp, bp, x, b, f, bytes;
  __host__ __device__ StateSmemF(int Q, int N) {
    const int Qp = pad16(Q), Np = pad16(N);
    xp = kPT;
    bp = Np;
    x = 0;
    b = x + Qp * xp;
    f = b + Qp * bp;
    bytes = (f + 3 * kMaxQ + 4) * 4;
  }
};
struct ScanSmemF {
  int cp, mp, sp, c, r, x, s, m, f, bytes;
  __host__ __device__ ScanSmemF(int Q, int N) {
    const int Qp = pad16(Q), Np = pad16(N);
    cp = Np + 4;
    mp = Qp + 4;
    sp = Np + 4;
    c = 0;
    r = c + Qp * cp;                  // B, later x and the carried state
    x = r;
    s = x + Qp * kPT;
    const int rb = Qp * cp, rxs = Qp * kPT + kPT * sp;
    const int rsize = rb > rxs ? rb : rxs;
    m = r + rsize;
    f = m + Qp * mp;
    bytes = (f + 2 * kMaxQ) * 4;
  }
};

// 1. The chunk's end state, f32.  Thread (warp, lane) owns state rows
// warp + 8 v and columns lane + 32 u of the block's tile.
__global__ void __launch_bounds__(kThreads)
    ssd_state_fma(const float* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ A, const float* __restrict__ Bm,
                  float* __restrict__ states, float* __restrict__ cum_out,
                  int S, int H, int P, int N, int Q, int flags) {
  extern __shared__ __align__(16) float smf[];
  const StateSmemF L(Q, N);
  float* Xs = smf + L.x;
  float* Bs = smf + L.b;
  float* dts = smf + L.f;
  float* cum = dts + kMaxQ;
  float* wgt = cum + kMaxQ;
  float* tot = wgt + kMaxQ;
  const int Qp = pad16(Q), Np = pad16(N);
  const int ptiles = (P + kPT - 1) / kPT, nc = S / Q;
  const int c = blockIdx.x / ptiles, p0 = (blockIdx.x % ptiles) * kPT;
  const int h = blockIdx.y, b = blockIdx.z;
  const int pv = min(kPT, P - p0);
  const size_t t0 = static_cast<size_t>(b) * S + static_cast<size_t>(c) * Q;

  load_tile(Xs, L.xp, x + (t0 * H + h) * P + p0, static_cast<size_t>(H) * P,
            Q, pv, Qp, kPT, flags & kVecX);
  load_tile(Bs, L.bp, Bm + t0 * N, N, Q, N, Qp, Np, flags & kVecBC);
  cp_async_commit();
  chunk_cumsum(dt + t0 * H + h, H, A[h], Q, dts, cum, tot);
  const int t = threadIdx.x;
  const float clast = cum[Q - 1];
  if (t < Q && p0 == 0)
    cum_out[(static_cast<size_t>(b) * H + h) * S + static_cast<size_t>(c) * Q +
            t] = cum[t];
  if (t < kMaxQ) wgt[t] = t < Q ? dts[t] * expf(clast - cum[t]) : 0.f;
  cp_async_wait<0>();
  __syncthreads();

  const int lane = t % 32, warp = t / 32;
  float acc[8][4];
#pragma unroll
  for (int v = 0; v < 8; ++v)
#pragma unroll
    for (int u = 0; u < 4; ++u) acc[v][u] = 0.f;
  for (int l = 0; l < Q; ++l) {
    const float w = wgt[l];
    float xv[8], bv[4];
#pragma unroll
    for (int v = 0; v < 8; ++v) xv[v] = Xs[l * L.xp + warp + 8 * v] * w;
#pragma unroll
    for (int u = 0; u < 4; ++u)
      bv[u] = lane + 32 * u < Np ? Bs[l * L.bp + lane + 32 * u] : 0.f;
#pragma unroll
    for (int v = 0; v < 8; ++v)
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[v][u] = fmaf(xv[v], bv[u], acc[v][u]);
  }
  float* out = states + ((static_cast<size_t>(b) * nc + c) * H + h) *
                            static_cast<size_t>(P) * N;
#pragma unroll
  for (int v = 0; v < 8; ++v) {
    const int pr = warp + 8 * v;
    if (pr >= pv) continue;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int n = lane + 32 * u;
      if (n < N) out[static_cast<size_t>(p0 + pr) * N + n] = acc[v][u];
    }
  }
}

// 3. y, f32.  First the block's C B^T o L o dt into shared memory (thread
// (ty, tx) of 16 x 16 owns rows ty + 16 a, columns tx + 16 e), then thread
// t owns chunk row t / 2 and 32 columns of the tile.
__global__ void __launch_bounds__(kThreads)
    ssd_scan_fma(const float* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ Bm, const float* __restrict__ Cm,
                 const float* __restrict__ states,
                 const float* __restrict__ cum_in, float* __restrict__ y,
                 int S, int H, int P, int N, int Q, int flags) {
  extern __shared__ __align__(16) float smf[];
  const ScanSmemF L(Q, N);
  float* Cs = smf + L.c;
  float* Bs = smf + L.r;
  float* Xs = smf + L.x;
  float* Ss = smf + L.s;
  float* Ms = smf + L.m;
  float* dts = smf + L.f;
  float* cums = dts + kMaxQ;
  const int Qp = pad16(Q), Np = pad16(N);
  const int ptiles = (P + kPT - 1) / kPT, nc = S / Q;
  const int c = blockIdx.x / ptiles, p0 = (blockIdx.x % ptiles) * kPT;
  const int h = blockIdx.y, b = blockIdx.z;
  const int pv = min(kPT, P - p0);
  const size_t t0 = static_cast<size_t>(b) * S + static_cast<size_t>(c) * Q;
  const int t = threadIdx.x;

  load_tile(Cs, L.cp, Cm + t0 * N, N, Q, N, Qp, Np, flags & kVecBC);
  load_tile(Bs, L.cp, Bm + t0 * N, N, Q, N, Qp, Np, flags & kVecBC);
  cp_async_commit();
  if (t < kMaxQ) {
    const float* cq = cum_in + (static_cast<size_t>(b) * H + h) * S +
                      static_cast<size_t>(c) * Q;
    dts[t] = t < Q ? dt[(t0 + t) * H + h] : 0.f;
    cums[t] = cq[min(t, Q - 1)];
  }
  cp_async_wait<0>();
  __syncthreads();
  {
    const int ty = t / 16, tx = t % 16;
    float acc[8][8];
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[a][e] = 0.f;
    for (int k = 0; k < Np; ++k) {
      float cv[8], bv[8];
#pragma unroll
      for (int a = 0; a < 8; ++a)
        cv[a] = ty + 16 * a < Qp ? Cs[(ty + 16 * a) * L.cp + k] : 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e)
        bv[e] = tx + 16 * e < Qp ? Bs[(tx + 16 * e) * L.cp + k] : 0.f;
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[a][e] = fmaf(cv[a], bv[e], acc[a][e]);
    }
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      const int i = ty + 16 * a;
      if (i >= Qp) continue;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int j = tx + 16 * e;
        if (j < Qp)
          Ms[i * L.mp + j] =
              j <= i ? acc[a][e] * expf(cums[i] - cums[j]) * dts[j] : 0.f;
      }
    }
  }
  __syncthreads();                   // every read of B is done
  load_tile(Xs, kPT, x + (t0 * H + h) * P + p0, static_cast<size_t>(H) * P,
            Q, pv, Qp, kPT, flags & kVecX);
  if (c > 0)
    load_tile(Ss, L.sp,
              states + ((static_cast<size_t>(b) * nc + c) * H + h) *
                           static_cast<size_t>(P) * N +
                  static_cast<size_t>(p0) * N,
              N, pv, N, kPT, Np, flags & kVecS);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int row = t / 2, c0 = (t % 2) * 32;
  if (row >= Q) return;
  float acc[32];
#pragma unroll
  for (int u = 0; u < 32; ++u) acc[u] = 0.f;
  if (c > 0) {
    for (int k = 0; k < N; ++k) {
      const float cv = Cs[row * L.cp + k];
#pragma unroll
      for (int u = 0; u < 32; ++u)
        acc[u] = fmaf(cv, Ss[(c0 + u) * L.sp + k], acc[u]);
    }
    const float e = expf(cums[row]);
#pragma unroll
    for (int u = 0; u < 32; ++u) acc[u] *= e;
  }
  for (int j = 0; j <= row; ++j) {
    const float m = Ms[row * L.mp + j];
#pragma unroll
    for (int u = 0; u < 32; ++u)
      acc[u] = fmaf(m, Xs[j * kPT + c0 + u], acc[u]);
  }
  float* yr = y + ((t0 + row) * H + h) * P + p0;
#pragma unroll
  for (int u = 0; u < 32; ++u)
    if (c0 + u < pv) yr[c0 + u] = acc[u];
}

// ---------------------------------------------------------------------------
// 2. the state carry (both dtypes)
// ---------------------------------------------------------------------------

// The state before chunk c (c >= 1), written over the chunk's end state
// where the scan of T reads it: f32, or each element's bf16 (hi, lo) pair
// in its 4 bytes for the tensor-core scan.
__device__ __forceinline__ uint32_t f32_bits(float v) {
  return __float_as_uint(v);
}
__device__ __forceinline__ uint32_t split_bits(float v) {
  const bf16 hi = __float2bfloat16(v);
  const bf16 lo = __float2bfloat16(v - __bfloat162float(hi));
  return static_cast<uint32_t>(__bfloat16_as_ushort(hi)) |
         static_cast<uint32_t>(__bfloat16_as_ushort(lo)) << 16;
}

// Grid (ceil(P N / (4 kPassThreads)), H, Bsz): thread t owns state elements
// 4 t .. 4 t + 3 of one head and walks the chunks in order, four at a time
// (their loads in flight together), replacing each chunk's end state by the
// state before it.
template <typename T>
__global__ void __launch_bounds__(kPassThreads)
    ssd_state_pass(float* __restrict__ states,
                   const float* __restrict__ cum,
                   float* __restrict__ final_state, int S, int H, int P,
                   int N, int Q) {
  const int nc = S / Q, h = blockIdx.y, b = blockIdx.z;
  const size_t PN = static_cast<size_t>(P) * N;
  const size_t e = (static_cast<size_t>(blockIdx.x) * kPassThreads +
                    threadIdx.x) * 4;
  if (e >= PN) return;
  const int cnt = PN - e < 4 ? static_cast<int>(PN - e) : 4;
  const bool vec = cnt == 4 && PN % 4 == 0;
  const float* cl = cum + (static_cast<size_t>(b) * H + h) * S + (Q - 1);
  float* base = states + (static_cast<size_t>(b) * nc * H + h) * PN + e;
  const size_t step = static_cast<size_t>(H) * PN;
  float s[4] = {0.f, 0.f, 0.f, 0.f};
  for (int c0 = 0; c0 < nc; c0 += 4) {
    float v[4][4], d[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int c = c0 + k;
      if (c >= nc) continue;
      d[k] = expf(cl[static_cast<size_t>(c) * Q]);
      const float* src = base + c * step;
      if (vec) {
        const float4 q = *reinterpret_cast<const float4*>(src);
        v[k][0] = q.x;
        v[k][1] = q.y;
        v[k][2] = q.z;
        v[k][3] = q.w;
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u) v[k][u] = u < cnt ? src[u] : 0.f;
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int c = c0 + k;
      if (c >= nc) continue;
      if (c > 0) {                   // chunk 0's scan reads no state
        uint32_t w[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          w[u] = sizeof(T) == 2 ? split_bits(s[u]) : f32_bits(s[u]);
        uint32_t* dst = reinterpret_cast<uint32_t*>(base + c * step);
        if (vec) {
          *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
        } else {
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (u < cnt) dst[u] = w[u];
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) s[u] = s[u] * d[k] + v[k][u];
    }
  }
  float* out = final_state + (static_cast<size_t>(b) * H + h) * PN + e;
#pragma unroll
  for (int u = 0; u < 4; ++u)
    if (u < cnt) out[u] = s[u];
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// The three launches of one dtype: T the element type of x, B, C and y,
// SL / CL the shared-memory layouts of its state and scan kernels, and ST
// the scan's view of the carried state (f32, or packed (hi, lo) bf16).
template <typename T, typename ST, typename SL, typename CL, auto kState,
          auto kScan>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, void* states, void* cum, void* y,
           void* final_state, int Bsz, int S, int H, int P, int N, int Q,
           void* stream) {
  if (Q < 1 || Q > kMaxQ || N < 1 || N > kMaxN || S % Q || P < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  // once per dtype, before any capture: the most shared memory any shape
  // asks for
  static const cudaError_t ready = [] {
    cudaError_t e = cudaFuncSetAttribute(
        kState, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SL(kMaxQ, kMaxN).bytes);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kScan,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               CL(kMaxQ, kMaxN).bytes);
    return e;
  }();
  if (ready != cudaSuccess) return static_cast<int>(ready);
  constexpr int E = 16 / sizeof(T);
  int flags = 0;
  if (P % E == 0 && aligned16(x)) flags |= kVecX;
  if (N % E == 0 && aligned16(Bm) && aligned16(Cm)) flags |= kVecBC;
  if (N % 4 == 0 && aligned16(states)) flags |= kVecS;
  const auto strm = static_cast<cudaStream_t>(stream);
  const dim3 grid(S / Q * ((P + kPT - 1) / kPT), H, Bsz);
  kState<<<grid, kThreads, SL(Q, N).bytes, strm>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<float*>(states), static_cast<float*>(cum), S, H, P, N, Q,
      flags);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long pn4 = (static_cast<long long>(P) * N + 3) / 4;
  const dim3 pass_grid(static_cast<unsigned>((pn4 + kPassThreads - 1) /
                                             kPassThreads),
                       H, Bsz);
  ssd_state_pass<T><<<pass_grid, kPassThreads, 0, strm>>>(
      static_cast<float*>(states), static_cast<const float*>(cum),
      static_cast<float*>(final_state), S, H, P, N, Q);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  kScan<<<grid, kThreads, CL(Q, N).bytes, strm>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const T*>(Bm), static_cast<const T*>(Cm),
      static_cast<const ST*>(states), static_cast<const float*>(cum),
      static_cast<T*>(y), S, H, P, N, Q, flags);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (of x, B, C and y).  x [Bsz, S, H, P],
// dt [Bsz, S, H] f32, A [H] f32, B/C [Bsz, S, N], y like x, final_state
// [Bsz, H, P, N] f32; scratch: states [Bsz, S/Q, H, P, N] f32 and cum
// [Bsz, H, S] f32; all contiguous.  1 <= Q <= 128, S % Q == 0,
// 1 <= N <= 128.
extern "C" int ssd_scan_fwd(int dtype, const void* x, const void* dt,
                            const void* A, const void* Bm, const void* Cm,
                            void* states, void* cum, void* y,
                            void* final_state, int Bsz, int S, int H, int P,
                            int N, int Q, void* stream) {
  if (Bsz <= 0 || S <= 0 || H <= 0) return 0;
  if (dtype == 0)
    return launch<float, float, StateSmemF, ScanSmemF, ssd_state_fma,
                  ssd_scan_fma>(x, dt, A, Bm, Cm, states, cum, y, final_state,
                                Bsz, S, H, P, N, Q, stream);
  if (dtype == 1)
    return launch<bf16, uint32_t, StateSmem, ScanSmem, ssd_state_mma,
                  ssd_scan_mma>(x, dt, A, Bm, Cm, states, cum, y, final_state,
                                Bsz, S, H, P, N, Q, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The entry point's version: 2 takes the states and cum scratch buffers
// (the first version took a C B^T scratch and had no such symbol).
extern "C" int ssd_scan_interface() { return 2; }

extern "C" const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
