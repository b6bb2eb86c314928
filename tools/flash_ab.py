#!/usr/bin/env python3
"""Compare versions of the flash-attention kernel on one card, in turns.

    python3 tools/flash_ab.py [OTHER.cu ...]

Builds each OTHER.cu (a version of ``src/repro_torch/csrc/
flash_attention.cu`` with the same C interface, named by its directory)
with the repository's nvcc flags, then calls the tree's kernel and each
other version through the port's wrapper at three shapes (bf16, B 1,
causal, D 128: 32 / 8 heads at S 512 and 2048, the mixtral draft's prefill;
24 / 8 heads at S 512, the llama3.2-3b draft's), in the order versions,
tree, tree, reversed versions.  For each it prints the event time per call
(which the host's issue time can set), the device time and device kernels
per call from ``torch.profiler``, and the largest difference from the plain
version relative to each query row's max |out|.  One JSON line per shape;
the card's name and power limit first.
"""
from __future__ import annotations

import ctypes
import json
import sys
from pathlib import Path

from ab_common import ROOT, build, card, time_call

SHAPES = (("B1 S512 32x8x128 causal", 512, 32, 8),
          ("B1 S2048 32x8x128 causal", 2048, 32, 8),
          ("B1 S512 24x8x128 causal", 512, 24, 8))


def main() -> int:
    import torch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ref as R
    if not torch.cuda.is_available():
        print("flash_ab: no CUDA device", file=sys.stderr)
        return 2
    print(card())
    tree_lib = FA._lib()
    srcs = [Path(p) for p in sys.argv[1:]]
    others = []
    for src, lib in zip(srcs, build(srcs, ROOT / "build" / "flash_ab")):
        lib.flash_attention_fwd.argtypes = tree_lib.flash_attention_fwd.argtypes
        lib.flash_attention_fwd.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        lib._repro_bound = True
        others.append((src.parent.name or src.stem, lib))
    order = others + [("tree", tree_lib), ("tree", tree_lib)] + others[::-1]
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(0)
    for name, S, H, Hkv in SHAPES:
        q = torch.randn((1, S, H, 128), generator=gen, device=dev).bfloat16()
        k, v = [torch.randn((1, S, Hkv, 128), generator=gen, device=dev)
                .bfloat16() for _ in range(2)]
        want = R.flash_attention_ref(q, k, v).float()
        scale = want.abs().amax(dim=-1).clamp_min(1e-30)
        rows = []
        for tag, lib in order:
            FA._lib = lambda lib=lib: lib
            call = lambda: FA.flash_attention(q, k, v)  # noqa: E731
            got = call().float()
            err = ((got - want).abs().amax(dim=-1) / scale).max().item()
            rows.append({"version": tag, **time_call(call, iters=50),
                         "max_row_rel_err": err})
        FA._lib = lambda: tree_lib
        print(json.dumps({"shape": name, "runs": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
