#!/usr/bin/env python3
"""Compare versions of the flash-decode kernel on one card, in turns.

    python3 tools/decode_ab.py [OTHER.cu ...]

Builds each OTHER.cu (a version of ``src/repro_torch/csrc/
decode_attention.cu``, named by its directory) with the repository's nvcc
flags, then calls the tree's kernel and each other version through the
port's wrapper at three shapes (bf16, one row, 24 / 8 heads x 128 at length
543 of a 576-slot cache; 32 / 8 heads x 128 at 4096 and at 100 of 4112), in
the order versions, tree, tree, reversed versions.  A version whose
``decode_attention_fwd`` takes three scratch buffers (the two-pass kernels,
whose source names ``part_m``) is called through a shim that allocates them
per call, as their wrapper did.  For each it prints the event time per call
(which the host's issue time can set), the device time and device kernels
per call and each kernel's time from ``torch.profiler``, and the largest
difference from the plain version.  One JSON line per shape; the card's
name and power limit first.
"""
from __future__ import annotations

import ctypes
import json
import sys
from pathlib import Path

from ab_common import ROOT, build, card, time_call

SHAPES = (("24x8x128 len 543 of 576", 24, 8, 128, 576, 543),
          ("32x8x128 len 4096 of 4112", 32, 8, 128, 4112, 4096),
          ("32x8x128 len 100 of 4112", 32, 8, 128, 4112, 100))
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
        self.decode_attention_max_rep = lib.decode_attention_max_rep

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
    lib.decode_attention_max_rep.restype = _I
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
    tree_lib = DA._lib()
    srcs = [Path(p) for p in sys.argv[1:]]
    others = [(src.parent.name or src.stem, bind(lib, src)) for src, lib in
              zip(srcs, build(srcs, ROOT / "build" / "decode_ab"))]
    order = others + [("tree", tree_lib), ("tree", tree_lib)] + others[::-1]
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(0)
    for name, H, Hkv, D, S, n in SHAPES:
        q = torch.randn((1, H, D), generator=gen, device=dev).bfloat16()
        k, v = [torch.randn((1, S, Hkv, D), generator=gen, device=dev)
                .bfloat16() for _ in range(2)]
        lens = torch.tensor([n], dtype=torch.int32, device=dev)
        want = R.decode_attention_ref(q, k, v, lens).float()
        rows = []
        for tag, lib in order:
            DA._lib = lambda lib=lib: lib
            call = lambda: DA.decode_attention(q, k, v, lens)  # noqa: E731
            err = (call().float() - want).abs().max().item()
            rows.append({"version": tag, **time_call(call),
                         "max_abs_err": err})
        DA._lib = lambda: tree_lib
        print(json.dumps({"shape": name, "runs": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
