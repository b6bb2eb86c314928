// Flash-decode for Hopper (sm_90a), CUDA C++: one query token per batch row
// against a long KV cache.
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
// The tiles are kTile = 64 keys where the reference's are 256.
//
// Grid.  Pass 1 runs one block per (b x kv head, split).  The cache's
// ceil(S / kTile) tiles are dealt to at most kMaxSplits splits of equal
// runs of tiles; the split count comes from S, never from the live length,
// so the launch shape of a decode step does not depend on its position (a
// captured CUDA graph can replay it).  A split walks its tiles in order and
// stops at the row's length (a split that starts past it exits at once), and
// writes its (m, l, acc).  Pass 2, one thread per output element, merges
// the live splits in split order: M = max m_s, L = sum l_s exp(m_s - M),
// O = sum acc_s exp(m_s - M), out = O / max(L, 1e-30).  No atomics and a
// fixed order: a row's bits depend only on its own q, K, V, length and on S,
// never on B or on scheduling.
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
// At llama3.2-3b widths (H 24, Hkv 8, D 128, bf16) the bytes bound it by far
// (3 flops per byte against the 295 where the tensor cores would take over):
// length 543 is 2.2 MB, 0.66 us.  What the design does about it: each K and V
// element of the live prefix is read once, by one block, as 16-byte vectors
// that every thread issues at once into registers and then stores to shared
// memory: a tile's K and V fly together, the next tile's while this one's PV
// product runs; q and every intermediate stay on chip; splits spread a
// long prefix over up to kMaxSplits blocks per kv head.  A short prefix is
// bound by latency and the two launches, not by bytes.  Not yet done: TMA
// staging, tensor cores, one launch instead of two.
//
// Threads.  128 per block (4 warps).  Scores: thread t takes key t % 64 of
// the tile and half t / 64 of D, reads its row from shared memory (rows
// padded by 16 bytes, so 8 neighbouring keys hit distinct banks) against q
// (a broadcast) with one partial sum per 16-byte chunk, and the partial sums
// and then the two halves are added in order.  Softmax: warp w owns rows w,
// w + 4, ...; lane owns keys lane and lane + 32; max and sum are butterflies
// over the warp.  PV: thread t owns column t % D of rows t / D, t / D +
// 128 / D, ...; keys in order.
//
// C interface (bound with ctypes): every pointer is a device pointer, the
// stream is the caller's current stream, nothing is allocated here (the
// scratch comes from the wrapper, sized by decode_attention_splits), and the
// entry point returns the launch's cudaError_t (0 = launched).

#include <cmath>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 64;                // keys per tile (two per lane)
constexpr int kMaxSplits = 64;           // splits per (row, kv head)
constexpr int kMaxRep = 32;              // q heads per kv head

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

// p rounded to the value dtype, as the reference's p.astype(v.dtype).
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

// a 16-byte vector of T as floats
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

struct Strides {
  long long qb, qh, kb, ks, kh, vb, vs, vh;
};

// Tiles per split for a cache of S keys, and the number of splits.
__host__ __device__ __forceinline__ int tiles_per_split(int S) {
  const int tiles = (S + kTile - 1) / kTile;
  return (tiles + kMaxSplits - 1) / kMaxSplits;
}
__host__ __device__ __forceinline__ int num_splits(int S) {
  const int tiles = (S + kTile - 1) / kTile;
  const int tps = tiles_per_split(S);
  return (tiles + tps - 1) / tps;
}

__device__ __forceinline__ int live_length(const int* lengths, int b, int S) {
  return min(max(lengths[b], 0), S);
}

// One tile's [nj, D] rows of K or V (nj <= kTile) as 16-byte vectors: every
// thread loads its share into registers first (all loads in flight at once),
// then stores them to shared memory rows of kRow elements.
template <typename T, int D>
struct Tile {
  static constexpr int kV = 16 / sizeof(T);            // elements per vector
  static constexpr int kRow = D + kV;                  // padded row
  static constexpr int kPerRow = D / kV;
  static constexpr int kIters = (kTile * kPerRow + kThreads - 1) / kThreads;
  uint4 buf[kIters];

  __device__ __forceinline__ void load(const T* src, long long stride,
                                       int nj) {
#pragma unroll
    for (int it = 0; it < kIters; ++it) {
      const int i = threadIdx.x + it * kThreads;
      const int row = i / kPerRow;
      if (row < nj)
        buf[it] = __ldg(reinterpret_cast<const uint4*>(
            src + row * stride + (i - row * kPerRow) * kV));
    }
  }

  __device__ __forceinline__ void store(T* dst, int nj) const {
#pragma unroll
    for (int it = 0; it < kIters; ++it) {
      const int i = threadIdx.x + it * kThreads;
      const int row = i / kPerRow;
      if (row < nj)
        *reinterpret_cast<uint4*>(dst + row * kRow +
                                  (i - row * kPerRow) * kV) = buf[it];
    }
  }
};

// Dynamic shared memory of a split block (bytes): q [rep, D], the scores'
// two halves and later p [2, rep, kTile], and m / l / alpha [3, kMaxRep], in
// f32; then the K and the V tile [kTile, kRow] in T.
template <typename T, int D>
size_t split_smem(int rep) {
  return (static_cast<size_t>(rep) * (D + 2 * kTile) + 3 * kMaxRep) *
             sizeof(float) +
         2 * static_cast<size_t>(kTile) * Tile<T, D>::kRow * sizeof(T);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
decode_split(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const int* __restrict__ lengths,
             float* __restrict__ part_m, float* __restrict__ part_l,
             float* __restrict__ part_acc, int S, int Hkv, int rep,
             Strides st, float scale) {
  using Tl = Tile<T, D>;
  constexpr int kV = Tl::kV;
  constexpr int kRow = Tl::kRow;
  constexpr int kHalf = D / 2;
  constexpr int RG = kThreads / D;       // row groups of the PV step
  constexpr int NA = kMaxRep / RG;       // rows per thread in the PV step
  extern __shared__ float4 smem[];
  float* qs = reinterpret_cast<float*>(smem);          // [rep][D]
  float* sp = qs + rep * D;                            // [2][rep][kTile]
  float* m_run = sp + 2 * rep * kTile;                 // [kMaxRep]
  float* l_run = m_run + kMaxRep;
  float* alpha = l_run + kMaxRep;
  T* kbuf = reinterpret_cast<T*>(alpha + kMaxRep);     // [kTile][kRow]
  T* vbuf = kbuf + kTile * kRow;

  const int bh = blockIdx.x;
  const int split = blockIdx.y;
  const int nsplit = gridDim.y;
  const int b = bh / Hkv;
  const int kvh = bh - b * Hkv;
  const int len = live_length(lengths, b, S);
  const int span = tiles_per_split(S) * kTile;
  const int begin = split * span;
  if (begin >= len) return;              // uniform across the block
  const int end = min(len, begin + span);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const T* kb = k + b * st.kb + kvh * st.kh;
  const T* vb = v + b * st.vb + kvh * st.vh;

  Tl kt, vt;                             // a tile's K and V fly together
  kt.load(kb + begin * st.ks, st.ks, min(kTile, end - begin));
  vt.load(vb + begin * st.vs, st.vs, min(kTile, end - begin));
  for (int i = threadIdx.x; i < rep * D; i += kThreads) {
    const int r = i / D;
    qs[i] = to_f(q[b * st.qb + (kvh * rep + r) * st.qh + (i - r * D)]);
  }
  if (threadIdx.x < kMaxRep) {
    m_run[threadIdx.x] = -INFINITY;
    l_run[threadIdx.x] = 0.f;
  }
  const int rg = threadIdx.x / D;        // PV: rows rg, rg + RG, ...
  const int dcol = threadIdx.x - rg * D;  //     of column dcol
  float acc[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) acc[i] = 0.f;

  for (int j0 = begin; j0 < end; j0 += kTile) {
    const int nj = min(kTile, end - j0);
    kt.store(kbuf, nj);
    vt.store(vbuf, nj);
    __syncthreads();                     // tiles, q and the row state ready

    // scores, two halves of D: sp[h][r][j] = q_r[half h] . k_j[half h]
    {
      const int j = threadIdx.x & (kTile - 1);
      const int h = threadIdx.x / kTile;
      if (j < nj) {
        const T* row = kbuf + j * kRow + h * kHalf;
#pragma unroll
        for (int r = 0; r < kMaxRep; ++r) {
          if (r >= rep) break;
          const float* qr = qs + r * D + h * kHalf;
          // one partial sum per 16-byte chunk (short dependent chains),
          // added in chunk order
          float part[kHalf / kV];
#pragma unroll
          for (int c = 0; c < kHalf / kV; ++c) {
            float kvals[kV];
            unpack(*reinterpret_cast<const uint4*>(row + c * kV), kvals);
            part[c] = 0.f;
#pragma unroll
            for (int e = 0; e < kV; ++e)
              part[c] = fmaf(qr[c * kV + e], kvals[e], part[c]);
          }
          float s = part[0];
#pragma unroll
          for (int c = 1; c < kHalf / kV; ++c) s += part[c];
          sp[(h * rep + r) * kTile + j] = s;
        }
      }
    }
    __syncthreads();

    // online softmax over this tile: p (rounded to T) replaces half 0
    for (int r = warp; r < rep; r += kWarps) {
      float* s0 = sp + r * kTile;
      const float* s1 = sp + (rep + r) * kTile;
      const float a = lane < nj ? (s0[lane] + s1[lane]) * scale : -INFINITY;
      const float c = lane + 32 < nj
                          ? (s0[lane + 32] + s1[lane + 32]) * scale
                          : -INFINITY;
      float mt = fmaxf(a, c);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_prev = m_run[r];
      const float m_new = fmaxf(m_prev, mt);
      const float pa = lane < nj ? expf(a - m_new) : 0.f;
      const float pc = lane + 32 < nj ? expf(c - m_new) : 0.f;
      float l = pa + pc;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        l += __shfl_xor_sync(0xffffffffu, l, off);
      s0[lane] = round_to<T>(pa);
      s0[lane + 32] = round_to<T>(pc);
      __syncwarp();
      if (lane == 0) {
        const float al = expf(m_prev - m_new);
        alpha[r] = al;
        l_run[r] = l_run[r] * al + l;
        m_run[r] = m_new;
      }
    }
    if (j0 + kTile < end) {              // the next tiles fly during PV
      const int nn = min(kTile, end - j0 - kTile);
      kt.load(kb + (j0 + kTile) * st.ks, st.ks, nn);
      vt.load(vb + (j0 + kTile) * st.vs, st.vs, nn);
    }
    __syncthreads();

    // acc = acc * alpha + p @ v, keys in order
    float pv[NA];
#pragma unroll
    for (int i = 0; i < NA; ++i) pv[i] = 0.f;
#pragma unroll 8
    for (int j = 0; j < nj; ++j) {
      const float vv = to_f(vbuf[j * kRow + dcol]);
#pragma unroll
      for (int i = 0; i < NA; ++i) {
        const int r = rg + i * RG;
        if (r >= rep) break;
        pv[i] = fmaf(sp[r * kTile + j], vv, pv[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      const int r = rg + i * RG;
      if (r >= rep) break;
      acc[i] = fmaf(acc[i], alpha[r], pv[i]);
    }
    __syncthreads();                     // buffers free for the next tile
  }

  const size_t first = (static_cast<size_t>(bh) * nsplit + split) * rep;
#pragma unroll
  for (int i = 0; i < NA; ++i) {
    const int r = rg + i * RG;
    if (r >= rep) break;
    part_acc[(first + r) * D + dcol] = acc[i];
  }
  if (threadIdx.x < rep) {
    part_m[first + threadIdx.x] = m_run[threadIdx.x];
    part_l[first + threadIdx.x] = l_run[threadIdx.x];
  }
}

// out[b, kvh * rep + r, d] from the live splits' (m, l, acc), in split order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_combine(const int* __restrict__ lengths,
               const float* __restrict__ part_m,
               const float* __restrict__ part_l,
               const float* __restrict__ part_acc, T* __restrict__ out,
               int S, int Hkv, int rep, int D, int nsplit) {
  const int bh = blockIdx.x;
  const int b = bh / Hkv;
  const int kvh = bh - b * Hkv;
  const int span = tiles_per_split(S) * kTile;
  const int nlive = (live_length(lengths, b, S) + span - 1) / span;
  const size_t first = static_cast<size_t>(bh) * nsplit * rep;
  const int o = blockIdx.y * kThreads + threadIdx.x;
  if (o < rep * D) {
    const int r = o / D;
    const int d = o - r * D;
    // unrolled by 8 so that eight splits' loads fly at once
    float M = -INFINITY;
#pragma unroll 8
    for (int s = 0; s < nlive; ++s)
      M = fmaxf(M, part_m[first + s * rep + r]);
    float L = 0.f;
    float O = 0.f;
#pragma unroll 8
    for (int s = 0; s < nlive; ++s) {
      const size_t row = first + s * rep + r;
      const float w = expf(part_m[row] - M);
      L = fmaf(part_l[row], w, L);
      O = fmaf(part_acc[row * D + d], w, O);
    }
    const size_t at =
        (static_cast<size_t>(b) * Hkv * rep + kvh * rep + r) * D + d;
    out[at] = from_f<T>(nlive ? O / fmaxf(L, 1e-30f) : 0.f);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* lengths,
           void* out, float* part_m, float* part_l, float* part_acc, int B,
           int S, int Hkv, int rep, const Strides& st, float scale,
           cudaStream_t stream) {
  const int nsplit = num_splits(S);
  const size_t smem = split_smem<T, D>(rep);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_split<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  decode_split<T, D><<<dim3(B * Hkv, nsplit), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(lengths), part_m,
      part_l, part_acc, S, Hkv, rep, st, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid2(B * Hkv, (rep * D + kThreads - 1) / kThreads);
  decode_combine<T><<<grid2, kThreads, 0, stream>>>(
      static_cast<const int*>(lengths), part_m, part_l, part_acc,
      static_cast<T*>(out), S, Hkv, rep, D, nsplit);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int D, const void* q, const void* k, const void* v,
             const void* lengths, void* out, float* part_m, float* part_l,
             float* part_acc, int B, int S, int Hkv, int rep,
             const Strides& st, float scale, cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, lengths, out, part_m, part_l, part_acc,
                           B, S, Hkv, rep, st, scale, stream);
    case 32:
      return launch<T, 32>(q, k, v, lengths, out, part_m, part_l, part_acc,
                           B, S, Hkv, rep, st, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, lengths, out, part_m, part_l, part_acc,
                           B, S, Hkv, rep, st, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, lengths, out, part_m, part_l, part_acc,
                            B, S, Hkv, rep, st, scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Splits per (row, kv head) for a cache of S keys: the wrapper sizes the
// scratch as [B * Hkv * splits * rep] (m, l) and [... * D] (acc) f32.
extern "C" int decode_attention_splits(int S) {
  return S > 0 ? num_splits(S) : 0;
}

extern "C" int decode_attention_max_rep() { return kMaxRep; }

// dtype: 0 = float32, 1 = bfloat16.  q [B, H, D], k/v [B, S, Hkv, D] through
// strides (qb, qh, kb, ks, kh, vb, vs, vh; unit stride over D, k and v
// 16-byte aligned), lengths [B] int32, out [B, H, D] contiguous.
extern "C" int decode_attention_fwd(int dtype, const void* q, const void* k,
                                    const void* v, const void* lengths,
                                    void* out, void* part_m, void* part_l,
                                    void* part_acc, int B, int S, int H,
                                    int Hkv, int D, const long long* strides,
                                    float scale, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (Hkv <= 0 || H % Hkv || H / Hkv > kMaxRep)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides st{strides[0], strides[1], strides[2], strides[3],
                   strides[4], strides[5], strides[6], strides[7]};
  const auto s = static_cast<cudaStream_t>(stream);
  auto* pm = static_cast<float*>(part_m);
  auto* pl = static_cast<float*>(part_l);
  auto* pa = static_cast<float*>(part_acc);
  if (dtype == 0)
    return dispatch<float>(D, q, k, v, lengths, out, pm, pl, pa, B, S, Hkv,
                           H / Hkv, st, scale, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(D, q, k, v, lengths, out, pm, pl, pa, B,
                                   S, Hkv, H / Hkv, st, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* decode_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
