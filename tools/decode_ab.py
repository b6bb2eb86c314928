#!/usr/bin/env python3
"""Compare versions of the flash-decode kernel on one card, in turns.

    python3 tools/decode_ab.py [--dims D ... [--heads H/HKV ...]] [OTHER.cu ...]

Builds each OTHER.cu (a version of ``src/repro_torch/csrc/
decode_attention.cu``, named by its directory) with the repository's nvcc
flags, then calls the tree's kernel and each other version through the
port's wrapper at the served shapes (bf16, one row, 24 / 8 heads x 128 at
length 543 of a 576-slot cache; 32 / 8 heads x 128 at 4096 and at 100 of
4112; at 543 of 576 zamba2-7b's 32 / 32 x 112, nemotron-4-340b's 96 / 8 x
192 and granite-20b's 48 / 1 x 128; whisper-medium's 16 / 16 x 64 at 192 of
192) and at chip_smoke.py's ANY_HEAD_DIMS (32 / 8 heads at 543 of 576: D 4,
20 and 100, which bf16 runs in the narrow copies, and 264, 320 and 512, the
wide instance); with ``--dims`` at those head dims only, and with
``--heads`` at each of those head shapes (q heads / kv heads) instead of
32 / 8, which sets how many blocks a call launches.  The order is
versions, tree, tree, reversed versions.  A version whose
``decode_attention_fwd`` takes three scratch buffers (the two-pass kernels,
whose source names ``part_m``) is called through a shim that allocates them
per call, as their wrapper did.  For each it prints the event time per call
(which the host's issue time can set), the device time and device kernels
per call and each kernel's time from ``torch.profiler``, the kernels' names
(which instance ran), whether the output equals the first version's bit for
bit, and the largest difference from the plain version.  One JSON line per
shape; the card's name and power limit first.
"""
from __future__ import annotations

import ctypes
import json
import re
import sys
from pathlib import Path

from ab_common import ROOT, build, card, time_call

SHAPES = (("24x8x128 len 543 of 576", 24, 8, 128, 576, 543),
          ("32x8x128 len 4096 of 4112", 32, 8, 128, 4112, 4096),
          ("32x8x128 len 100 of 4112", 32, 8, 128, 4112, 100),
          ("32x32x112 len 543 of 576", 32, 32, 112, 576, 543),
          ("96x8x192 len 543 of 576", 96, 8, 192, 576, 543),
          ("48x1x128 len 543 of 576", 48, 1, 128, 576, 543),
          ("16x16x64 len 192 of 192", 16, 16, 64, 192, 192))
ANY_DIMS = (4, 20, 100, 264, 320, 512)
_P, _I = ctypes.c_void_p, ctypes.c_int


class ScratchShim:
    """The one-pass interface over a two-pass version: allocates its (m, l,
    acc) scratch per call and passes it on."""

    _repro_bound = True

    def __init__(self, lib: ctypes.CDLL):
        import torch
        self.torch = torch
        self.lib = lib
        lib.decode_attention_fwd.argtypes = [
            _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
            ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, _P]
        lib.decode_attention_fwd.restype = _I
        lib.decode_attention_splits.argtypes = [_I]
        lib.decode_attention_splits.restype = _I
        self.decode_attention_error_string = lib.decode_attention_error_string

    def decode_attention_fwd(self, dtype, q, k, v, lengths, out, B, S, H,
                             Hkv, D, strides, scale, stream):
        rows = B * Hkv * self.lib.decode_attention_splits(S) * (H // Hkv)
        f32 = dict(dtype=self.torch.float32, device="cuda")
        pm, pl = self.torch.empty(rows, **f32), self.torch.empty(rows, **f32)
        pa = self.torch.empty(rows * D, **f32)
        return self.lib.decode_attention_fwd(
            dtype, q, k, v, lengths, out, pm.data_ptr(), pl.data_ptr(),
            pa.data_ptr(), B, S, H, Hkv, D, strides, scale, stream)


def bind(lib: ctypes.CDLL, src: Path):
    from repro_torch.kernels import decode_attention as DA
    lib.decode_attention_error_string.argtypes = [_I]
    lib.decode_attention_error_string.restype = ctypes.c_char_p
    if "part_m" in src.read_text():
        return ScratchShim(lib)
    lib.decode_attention_fwd.argtypes = DA._lib().decode_attention_fwd.argtypes
    lib.decode_attention_fwd.restype = _I
    lib._repro_bound = True
    return lib


def main() -> int:
    import torch
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import ref as R
    if not torch.cuda.is_available():
        print("decode_ab: no CUDA device", file=sys.stderr)
        return 2
    print(card())
    args = sys.argv[1:]
    shapes = SHAPES + tuple((f"32x8x{D} len 543 of 576", 32, 8, D, 576, 543)
                            for D in ANY_DIMS)
    if args[:1] == ["--dims"]:
        dims = [int(a) for a in args[1:] if a.isdigit()]
        args = [a for a in args[1:] if not a.isdigit()]
        heads = [(32, 8)]
        if args[:1] == ["--heads"]:
            pair = re.compile(r"^\d+/\d+$")
            heads = [tuple(map(int, a.split("/"))) for a in args[1:]
                     if pair.match(a)]
            args = [a for a in args[1:] if not pair.match(a)]
        shapes = tuple((f"{H}x{Hkv}x{D} len 543 of 576", H, Hkv, D, 576, 543)
                       for D in dims for H, Hkv in heads)
    tree_lib = DA._lib()
    srcs = [Path(p) for p in args]
    others = [(src.parent.name or src.stem, bind(lib, src)) for src, lib in
              zip(srcs, build(srcs, ROOT / "build" / "decode_ab"))]
    order = others + [("tree", tree_lib), ("tree", tree_lib)] + others[::-1]
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(0)
    for name, H, Hkv, D, S, n in shapes:
        q = torch.randn((1, H, D), generator=gen, device=dev).bfloat16()
        k, v = [torch.randn((1, S, Hkv, D), generator=gen, device=dev)
                .bfloat16() for _ in range(2)]
        lens = torch.tensor([n], dtype=torch.int32, device=dev)
        want = R.decode_attention_ref(q, k, v, lens).float()
        rows = []
        first = None
        for tag, lib in order:
            DA._lib = lambda lib=lib: lib
            call = lambda: DA.decode_attention(q, k, v, lens)  # noqa: E731
            out = call()
            first = out if first is None else first
            err = (out.float() - want).abs().max().item()
            rows.append({"version": tag, **time_call(call),
                         "equal_to_first": bool(torch.equal(out, first)),
                         "max_abs_err": err})
        DA._lib = lambda: tree_lib
        print(json.dumps({"shape": name, "runs": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
