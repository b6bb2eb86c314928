"""What the A/B tools share: building another version of a kernel source
with the repository's nvcc flags, and timing one call on the card."""
from __future__ import annotations

import ctypes
import subprocess
import sys
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def card() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def build(sources, out_dir: Path):
    """Each source compiled like the tree's kernels (its own directory and
    the tree's ``csrc/`` on the include path), all at once, and loaded."""
    from repro_torch.kernels import _build
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for i, src in enumerate(sources):
        out = out_dir / f"lib{i}.so"
        procs.append((out, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(src.parent), "-I",
             str(_build.CSRC), "-o", str(out), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = []
    for out, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {out}:\n{log}")
        libs.append(ctypes.CDLL(str(out)))
    return libs


def time_call(call, iters: int = 200, traced: int = 50) -> dict:
    """One call's event time (which the host's issue time can set), its
    device time from ``torch.profiler`` (the sum of its kernels' and
    copies' durations), its device kernels per call, and each kernel's time
    per call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(10):
        call()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        call()
    b.record()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(traced):
            call()
        torch.cuda.synchronize()
    per = defaultdict(float)
    n = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            kernel = e.name.split("<")[0].split("::")[-1].split("(")[0]
            kernel = kernel.removeprefix("void ")
            per[kernel] += (e.time_range.end - e.time_range.start) / traced
            n += 1
    return {"event_us": a.elapsed_time(b) / iters * 1e3,
            "device_us": sum(per.values()), "kernels_per_call": n / traced,
            "kernels_us": dict(per)}
