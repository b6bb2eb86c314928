#!/usr/bin/env python3
"""Compare versions of the SSD-scan kernel on one card, in turns.

    python3 tools/ssd_ab.py [OTHER.cu ...]

Builds each OTHER.cu (a version of ``src/repro_torch/csrc/ssd_scan.cu``,
named by its directory) with the repository's nvcc flags, then calls the
tree's kernel and each other version through the port's wrapper
(``kernels/ssd_scan.py::ssd_scan``, bf16, b 1, chunk 128) at three shapes:
mamba2-780m's widths (h 48, p 64, n 128) at S 512 and S 2048, and
zamba2-7b's (h 112, p 64, n 64) at S 512, in the order versions, tree, tree,
reversed versions.  The inputs are drawn as ``chip_smoke.py`` draws them (dt
log-uniform in [1e-3, 1e-1], A = -(1..h)).  A version without
``ssd_scan_interface`` (whose entry point takes a [b, S/Q, Q, Q] C B^T
scratch instead of the tree's scratch buffers) is called through a
shim that allocates that scratch on every call, as its own wrapper did.  For
each it prints the event time per call (which the host's issue time can
set), the device time of the call's kernels and their count per call from
``torch.profiler``, and the largest difference of y and of the final state
from the plain version ``ref.ssd_ref``, relative to its max |value|.  Beside
them, once per shape: the bound (x, y, B, C, dt, A and the final state once
at 3.35 TB/s, or the per-head algorithm's operations at 989 TFLOP/s,
whichever is longer).  One JSON line per shape; the card's name and power
limit first.
"""
from __future__ import annotations

import ctypes
import json
import math
import sys
from pathlib import Path

from ab_common import ROOT, build, card, time_call

SHAPES = (("mamba2", 512, 48, 64, 128), ("mamba2", 2048, 48, 64, 128),
          ("zamba2", 512, 112, 64, 64))
CHUNK = 128
HBM_BYTES_S, BF16_FLOPS = 3.35e12, 989e12
_P, _I = ctypes.c_void_p, ctypes.c_int


class CbShim:
    """The tree's interface over a version whose entry point takes a C B^T
    scratch: allocates it and drops the tree's scratch buffers."""

    _repro_bound = True

    def __init__(self, lib: ctypes.CDLL):
        self.lib = lib
        lib.ssd_scan_fwd.argtypes = [_I] + [_P] * 8 + [_I] * 6 + [_P]
        lib.ssd_scan_fwd.restype = _I
        lib.ssd_scan_error_string.argtypes = [_I]
        lib.ssd_scan_error_string.restype = ctypes.c_char_p
        self.ssd_scan_error_string = lib.ssd_scan_error_string

    def ssd_scan_fwd(self, code, x, dt, A, B, C, states, cum, y, state, b, s,
                     h, p, n, q, stream):
        import torch
        cb = torch.empty((b, s // q, q, q), dtype=torch.float32,
                         device="cuda")
        return self.lib.ssd_scan_fwd(code, x, dt, A, B, C, cb.data_ptr(), y,
                                     state, b, s, h, p, n, q, stream)


def bind(lib: ctypes.CDLL, tree_lib: ctypes.CDLL):
    if not hasattr(lib, "ssd_scan_interface"):
        return CbShim(lib)
    for name in ("ssd_scan_fwd", "ssd_scan_error_string"):
        fn = getattr(lib, name)
        fn.argtypes = getattr(tree_lib, name).argtypes
        fn.restype = getattr(tree_lib, name).restype
    lib._repro_bound = True
    return lib


def inputs(gen, dev, S: int, h: int, p: int, n: int):
    import torch
    u = torch.rand((1, S, h), generator=gen, device=dev)
    dt = torch.exp(u * (math.log(0.1) - math.log(0.001)) + math.log(0.001))
    A = -torch.arange(1, h + 1, dtype=torch.float32, device=dev)
    x, B, C = [torch.randn(shape, generator=gen, device=dev).bfloat16()
               for shape in ((1, S, h, p), (1, S, n), (1, S, n))]
    return x, dt, A, B, C


def bound_us(S: int, h: int, p: int, n: int):
    Q = CHUNK
    flops = h * (S // Q) * 2 * (Q * Q * n + Q * Q * p + 2 * Q * n * p)
    nbytes = (2 * S * h * p + 2 * S * n) * 2 + (S * h + h + h * p * n) * 4
    t_ops, t_bytes = flops / BF16_FLOPS * 1e6, nbytes / HBM_BYTES_S * 1e6
    return max(t_ops, t_bytes), "bytes" if t_bytes >= t_ops else "operations"


def main() -> int:
    import torch
    from repro_torch.kernels import ref as R
    from repro_torch.kernels import ssd_scan as SSD
    if not torch.cuda.is_available():
        print("ssd_ab: no CUDA device", file=sys.stderr)
        return 2
    print(card())
    tree_lib = SSD._lib()
    srcs = [Path(p) for p in sys.argv[1:]]
    others = [(src.parent.name or src.stem, bind(lib, tree_lib))
              for src, lib in zip(srcs, build(srcs, ROOT / "build" /
                                              "ssd_ab"))]
    order = others + [("tree", tree_lib), ("tree", tree_lib)] + others[::-1]
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(0)
    for model, S, h, p, n in SHAPES:
        x, dt, A, B, C = inputs(gen, dev, S, h, p, n)
        y_ref, st_ref = R.ssd_ref(x, dt, A, B, C, CHUNK)
        y_ref = y_ref.float()
        y_scale = y_ref.abs().max().item()
        st_scale = st_ref.abs().max().item()

        def call():
            return SSD.ssd_scan(x, dt, A, B, C, CHUNK)
        runs = []
        for tag, lib in order:
            SSD._lib = lambda lib=lib: lib
            y, st = call()
            t = time_call(call, iters=50, traced=20)
            runs.append({
                "version": tag, "event_us": t["event_us"],
                "device_us": t["device_us"],
                "kernels_per_call": t["kernels_per_call"],
                "kernels_us": t["kernels_us"],
                "y_max_rel_err": (y.float() - y_ref).abs().max().item()
                / max(y_scale, 1e-30),
                "state_max_rel_err": (st - st_ref).abs().max().item()
                / max(st_scale, 1e-30)})
        SSD._lib = lambda: tree_lib
        b_us, by = bound_us(S, h, p, n)
        print(json.dumps({"model": model, "S": S, "h": h, "p": p, "n": n,
                          "chunk": CHUNK, "dtype": "bfloat16",
                          "bound_us": b_us, "bound_by": by, "runs": runs}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
