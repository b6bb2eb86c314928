#!/usr/bin/env python3
"""Where a block of the SSD scan's bf16 kernels spends its time, on one card.

    python3 tools/ssd_phases.py [SOURCE.cu]

Copies SOURCE.cu (default: the tree's ``src/repro_torch/csrc/ssd_scan.cu``)
with a ``clock64()`` stamp added at each phase boundary of ``ssd_state_mma``
and ``ssd_scan_mma`` (one record per warp, and the block's SM and
``%globaltimer`` at start and end), builds it like the tree's kernels, and
calls it once, warm, through the port's wrapper at mamba2-780m's widths
(bf16, b 1, S 512, h 48, p 64, n 128, chunk 128).  Prints, per kernel, the
span from the first block's start to the latest end of a block's first
warp, and for each warp
the mean cycles (over blocks) from the block's start to each stamp and the
largest end.  Stamps, state kernel: start, prefix sum done, tiles in, product
done, end.  Scan kernel: start, C and the state in, C's rows in registers,
C S^T done, B and x in, tile loop done, end.  The anchors are lines of the
tree's source: a source without them is refused.
"""
from __future__ import annotations

import ctypes
import sys
from pathlib import Path

from ab_common import ROOT, build, card

HEAD = r'''
__device__ unsigned long long g_stamps[1 << 20];
__device__ __forceinline__ unsigned long long gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ unsigned smid() {
  unsigned s;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(s));
  return s;
}
#define STAMP_AT(base)                                            \
  ((base + (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x +    \
    blockIdx.x) * 80)
#define STAMP_END(base, n)                                        \
  {                                                               \
    ts_[n] = clock64();                                           \
    unsigned long long* d = g_stamps + STAMP_AT(base);            \
    if (threadIdx.x % 32 == 0)                                    \
      for (int k = 0; k <= n; ++k)                                \
        d[threadIdx.x / 32 * 8 + k] = ts_[k] - ts_[0];            \
    if (threadIdx.x == 0) {                                       \
      d[64] = smid();                                             \
      d[65] = g0_;                                                \
      d[66] = gtime();                                            \
    }                                                             \
  }
'''
TAIL = r'''
extern "C" int ssd_stamps_read(void* host, int n) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, g_stamps, n * 8));
}
'''
T0 = ("  const size_t t0 = static_cast<size_t>(b) * S + "
      "static_cast<size_t>(c) * Q;\n")
START = T0 + ("  long long ts_[8];\n  ts_[0] = clock64();\n"
              "  const unsigned long long g0_ = gtime();\n")
STATE = [
    ("  chunk_cumsum(dt + t0 * H + h, H, A[h], Q, dts, cum, tot);\n", 1,
     "after"),
    ("  hopper::fence_proxy_async();       // B, written by cp.async, read "
     "by wgmma\n  __syncthreads();\n", 2, "after"),
    ("  float* out = states", 3, "before"),
]
SCAN = [
    ("  cp_async_wait<1>();\n  __syncthreads();\n", 1, "after"),
    ("  __syncthreads();                   // every warp's C rows are read\n",
     2, "after"),
    ("  cp_async_wait<0>();\n  __syncthreads();\n", 3, "before"),
    ("  cp_async_wait<0>();\n  __syncthreads();\n", 4, "after"),
    ("\n#pragma unroll\n  for (int pt = 0; pt < kPT / 8; ++pt) {\n", 5,
     "before"),
]
KERNELS = (("ssd_state_mma", STATE, 0, 4), ("ssd_scan_mma", SCAN, 4096, 6))


def stamped(src: str) -> str:
    """``src`` with the stamps; raises where an anchor is missing."""
    s = src.replace("namespace {\n", "namespace {\n" + HEAD, 1)
    for name, anchors, base, last in KERNELS:
        a = s.index(f"    {name}(")
        b = s.index("\n}\n", a)
        body = s[a:b]
        if body.count(T0) != 1:
            raise ValueError(f"{name}: no single chunk-start line")
        body = body.replace(T0, START)
        for text, k, where in anchors:
            if body.count(text) != 1:
                raise ValueError(f"{name}: anchor for stamp {k} not found "
                                 f"once")
            stamp = f"  ts_[{k}] = clock64();\n"
            if where == "after":
                body = body.replace(text, text + stamp)
            elif text.startswith("\n"):
                body = body.replace(text, "\n" + stamp + text[1:])
            else:
                body = body.replace(text, stamp + text)
        s = s[:a] + body + f"\n  STAMP_END({base}, {last})" + s[b:]
    return s + TAIL


def main() -> int:
    import math
    import numpy as np
    import torch
    sys.path.insert(0, str(ROOT / "tools"))
    import ssd_ab
    from repro_torch.kernels import ssd_scan as SSD
    if not torch.cuda.is_available():
        print("ssd_phases: no CUDA device", file=sys.stderr)
        return 2
    print(card())
    src = Path(sys.argv[1]) if len(sys.argv) > 1 else \
        ROOT / "src/repro_torch/csrc/ssd_scan.cu"
    out = ROOT / "build" / "ssd_phases" / "src" / "ssd_scan.cu"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(stamped(src.read_text()))
    lib = ssd_ab.bind(build([out], ROOT / "build" / "ssd_phases")[0],
                      SSD._lib())
    SSD._lib = lambda: lib
    dev = torch.device("cuda")
    S, h, p, n, chunk = 512, 48, 64, 128, 128
    ins = ssd_ab.inputs(torch.Generator(dev).manual_seed(0), dev, S, h, p, n)
    for _ in range(3):
        SSD.ssd_scan(*ins, chunk)
    torch.cuda.synchronize()
    SSD.ssd_scan(*ins, chunk)
    torch.cuda.synchronize()
    buf = np.zeros(1 << 20, dtype=np.uint64)
    rc = lib.ssd_stamps_read(ctypes.c_void_p(buf.ctypes.data), 1 << 20)
    if rc:
        raise RuntimeError(f"reading the stamps failed ({rc})")
    blocks = S // chunk * math.ceil(p / 64) * h
    for name, _, base, last in KERNELS:
        rec = buf[base * 80:(base + blocks) * 80].reshape(blocks, 80)
        rec = rec.astype(np.float64)
        stamps = rec[:, :64].reshape(blocks, 8, 8)[:, :, :last + 1]
        g0, g1 = rec[:, 65], rec[:, 66]
        print(f"{name}: S {S}, {blocks} blocks on {len(set(rec[:, 64]))} "
              f"SMs, span {(g1.max() - g0.min()) / 1e3:.2f} us")
        for w in range(8):
            print(f"  warp {w}: mean cycles {np.round(stamps[:, w].mean(0))}"
                  f" largest end {int(stamps[:, w, last].max())}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
