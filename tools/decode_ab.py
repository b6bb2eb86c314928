#!/usr/bin/env python3
"""Compare versions of the flash-decode kernel on one card, in turns.

    python3 tools/decode_ab.py [OTHER.cu ...]

Builds each OTHER.cu (a version of ``src/repro_torch/csrc/
decode_attention.cu`` with the same C interface, named by its directory;
one that lacks ``decode_attention_splits`` is taken to split the cache into
64-key splits) with the repository's nvcc flags, then calls the tree's
kernel and each other version through the port's wrapper at three shapes
(bf16, one row, 24 / 8 heads x 128 at length 543 of a 576-slot cache;
32 / 8 heads x 128 at 4096 and at 100 of 4112), in the order versions,
tree, tree, reversed versions.  For each it prints the event time per call
(which the host's issue time can set), the device time of each of its
kernels per call from ``torch.profiler``, and the largest difference from
the plain version.  One JSON line per shape; the card's name and power
limit first.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

SHAPES = (("24x8x128 len 543 of 576", 24, 8, 128, 576, 543),
          ("32x8x128 len 4096 of 4112", 32, 8, 128, 4112, 4096),
          ("32x8x128 len 100 of 4112", 32, 8, 128, 4112, 100))


def build(src: Path, out: Path, argtypes) -> ctypes.CDLL:
    from repro_torch.kernels import _build
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                    str(src)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    lib.decode_attention_fwd.argtypes = argtypes
    lib.decode_attention_fwd.restype = ctypes.c_int
    lib.decode_attention_error_string.argtypes = [ctypes.c_int]
    lib.decode_attention_error_string.restype = ctypes.c_char_p
    if hasattr(lib, "decode_attention_splits"):
        lib.decode_attention_splits.argtypes = [ctypes.c_int]
        lib.decode_attention_splits.restype = ctypes.c_int
    else:
        lib.decode_attention_splits = lambda S: -(-S // 64)
    lib._repro_bound = True
    return lib


def main() -> int:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import ref as R
    if not torch.cuda.is_available():
        print("decode_ab: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    tree_lib = DA._lib()
    others = [(Path(p).parent.name or Path(p).stem,
               build(Path(p), ROOT / "build" / "decode_ab" /
                     f"lib{i}.so", tree_lib.decode_attention_fwd.argtypes))
              for i, p in enumerate(sys.argv[1:])]
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
            for _ in range(10):
                call()
            torch.cuda.synchronize()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(200):
                call()
            b.record()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(50):
                    call()
                torch.cuda.synchronize()
            per = defaultdict(float)
            for e in prof.events():
                if e.device_type == DeviceType.CUDA:
                    kernel = e.name.split("<")[0].split("::")[-1]
                    per[kernel] += (e.time_range.end -
                                    e.time_range.start) / 50
            rows.append({"version": tag,
                         "event_us": a.elapsed_time(b) / 200 * 1e3,
                         "device_us": sum(per.values()),
                         "kernels_us": dict(per), "max_abs_err": err})
        print(json.dumps({"shape": name, "runs": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
