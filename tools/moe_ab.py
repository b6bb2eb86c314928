#!/usr/bin/env python3
"""Compare versions of the expert-FFN kernel on one card, in turns.

    python3 tools/moe_ab.py [OTHER.cu ...]

Builds each OTHER.cu (a version of ``src/repro_torch/csrc/cache_moe.cu``,
named by its directory) with the repository's nvcc flags, then calls the
tree's kernel and each other version through the port's wrappers
(``kernels/cache_moe.py``: ``gate_up``, ``up_gelu``, ``down``) at the
mixtral-8x7b widths (bf16, d 4096, f 14336, a pool of 12 slots, top-2) and
two row counts: T 5, the verify block (a miss, a repeated slot; the seed
touches 4 slots), and T 512, the concurrent path's prefill block (8 slots,
~128 rows each), in the order versions, tree, tree, reversed versions.  A
version without ``cache_moe_interface`` (whose entry points take no pool
size and no row count) is called through a shim that drops them.  For each
it prints the event time per call
(which the host's issue time can set), the device time of the FFN kernel
alone and of the whole call (the wrapper's zeroed output included) from
``torch.profiler``, and the largest difference from the plain version
relative to its max |value|.  Beside them, once per case: the bound (the
touched slots' weights and the rows moved once at 3.35 TB/s, or the
operations at 989 TFLOP/s, whichever is longer) and the device time of the
``torch.bmm`` yardstick over the same slots (weights gathered beforehand,
untimed).  One JSON line per case; the card's name and power limit first.
"""
from __future__ import annotations

import ctypes
import json
import sys
from pathlib import Path

from ab_common import ROOT, build, card, time_call

D_MODEL, D_FF, POOL, TOP_K = 4096, 14336, 12, 2
HBM_BYTES_S, BF16_FLOPS = 3.35e12, 989e12
_P, _I = ctypes.c_void_p, ctypes.c_int


class PoolShim:
    """The tree's interface over a version whose entry points take no pool
    size and no row count: drops the two arguments."""

    _repro_bound = True

    def __init__(self, lib: ctypes.CDLL):
        self.lib = lib
        lib.cache_moe_gate_up.argtypes = [_I] + [_P] * 8 + [_I] * 3 + [_P]
        lib.cache_moe_up_gelu.argtypes = [_I] + [_P] * 7 + [_I] * 3 + [_P]
        lib.cache_moe_down.argtypes = [_I] + [_P] * 6 + [_I] * 3 + [_P]
        for fn in (lib.cache_moe_gate_up, lib.cache_moe_up_gelu,
                   lib.cache_moe_down):
            fn.restype = _I
        lib.cache_moe_error_string.argtypes = [_I]
        lib.cache_moe_error_string.restype = ctypes.c_char_p
        self.cache_moe_error_string = lib.cache_moe_error_string

    def cache_moe_gate_up(self, *a):
        return self.lib.cache_moe_gate_up(*a[:11], *a[13:])

    def cache_moe_up_gelu(self, *a):
        return self.lib.cache_moe_up_gelu(*a[:10], *a[12:])

    def cache_moe_down(self, *a):
        return self.lib.cache_moe_down(*a[:9], *a[11:])


def bind(lib: ctypes.CDLL, tree_lib: ctypes.CDLL):
    if not hasattr(lib, "cache_moe_interface"):
        return PoolShim(lib)
    for name in ("cache_moe_gate_up", "cache_moe_up_gelu", "cache_moe_down",
                 "cache_moe_error_string"):
        fn = getattr(lib, name)
        fn.argtypes = getattr(tree_lib, name).argtypes
        fn.restype = getattr(tree_lib, name).restype
    lib._repro_bound = True
    return lib


def inputs(T: int, gen, dev):
    """x [T, d] and its [T, 2] slots as chip_smoke.py draws them: a miss and
    a repeated slot at T 5, all 512 tokens on slots 0-7 at T 512."""
    import torch
    x = torch.randn((T, D_MODEL), generator=gen, device=dev).bfloat16()
    lo, hi = (0, 8) if T > 64 else (-1, POOL)
    si = torch.randint(lo, hi, (T, TOP_K), generator=gen, device=dev
                       ).to(torch.int32)
    si[0, 0] = -1
    si[1, 1] = si[1, 0] = max(int(si[1, 0]), 0)
    return x, si


def main() -> int:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import cache_moe as K
    from repro_torch.kernels import ref as R
    if not torch.cuda.is_available():
        print("moe_ab: no CUDA device", file=sys.stderr)
        return 2
    print(card())
    tree_lib = K._lib()
    srcs = [Path(p) for p in sys.argv[1:]]
    others = [(src.parent.name or src.stem, bind(lib, tree_lib))
              for src, lib in zip(srcs, build(srcs, ROOT / "build" /
                                              "moe_ab"))]
    order = others + [("tree", tree_lib), ("tree", tree_lib)] + others[::-1]
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(0)

    def w(shape, fan):
        return (torch.randn(shape, generator=gen, device=dev)
                * fan ** -0.5).bfloat16()
    wg = w((POOL, D_MODEL, D_FF), D_MODEL)
    wu = w((POOL, D_MODEL, D_FF), D_MODEL)
    wd = w((POOL, D_FF, D_MODEL), D_FF)
    for T in (5, 512):
        x, si = inputs(T, gen, dev)
        g = K.slot_groups(si, POOL)
        counts = g.grp_count.tolist()
        touched = [s for s, c in zip(g.grp_slot.tolist(), counts) if c]
        rows = sum(counts)
        idx = torch.tensor(touched, device=dev)
        C = max(counts)
        xg = torch.zeros((len(touched), C, D_MODEL), dtype=x.dtype,
                         device=dev)
        hg = torch.zeros((len(touched), C, D_FF), dtype=x.dtype, device=dev)
        wg_c, wu_c, wd_c = wg[idx], wu[idx], wd[idx]
        h = R.slot_gate_up_ref(x, g.row_tok, wg, wu, g.grp_slot, g.grp_start,
                               g.grp_count)
        P = g.row_tok.numel()
        cases = (
            ("cache_moe_gate_up", lambda: K.gate_up(x, g, wg, wu), h,
             lambda: (torch.bmm(xg, wg_c), torch.bmm(xg, wu_c)), 2,
             (T * D_MODEL + P * D_FF) * 2),
            ("cache_moe_up_gelu", lambda: K.up_gelu(x, g, wu),
             R.slot_up_gelu_ref(x, g.row_tok, wu, g.grp_slot, g.grp_start,
                                g.grp_count),
             lambda: F.gelu(torch.bmm(xg, wu_c), approximate="tanh"), 1,
             (T * D_MODEL + P * D_FF) * 2),
            ("cache_moe_down", lambda: K.down(h, g, wd),
             R.slot_down_ref(h, wd, g.grp_slot, g.grp_start, g.grp_count),
             lambda: torch.bmm(hg, wd_c), 1, P * (D_FF + D_MODEL) * 2))
        for name, call, want, lib_call, mats, io_bytes in cases:
            t_bytes = (len(touched) * mats * D_MODEL * D_FF * 2 + io_bytes) \
                / HBM_BYTES_S * 1e3
            t_ops = 2 * mats * rows * D_MODEL * D_FF / BF16_FLOPS * 1e3
            want = want.float()
            scale = want.abs().max().item()
            runs = []
            for tag, lib in order:
                K._lib = lambda lib=lib: lib
                got = call().float()
                t = time_call(call, iters=20, traced=10)
                kern = sum(us for k, us in t["kernels_us"].items()
                           if k.startswith("slot_ffn"))
                runs.append({"version": tag, "event_us": t["event_us"],
                             "kernel_us": kern, "device_us": t["device_us"],
                             "kernels_per_call": t["kernels_per_call"],
                             "max_rel_err": (got - want).abs().max().item()
                             / max(scale, 1e-30)})
            K._lib = lambda: tree_lib
            lib_t = time_call(lib_call, iters=20, traced=10)
            print(json.dumps({
                "case": name, "T": T, "touched_slots": len(touched),
                "rows": rows, "bound_us": max(t_bytes, t_ops) * 1e3,
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_device_us": lib_t["device_us"], "runs": runs}),
                flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
