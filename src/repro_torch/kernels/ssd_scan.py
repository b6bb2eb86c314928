"""Mamba2 chunked SSD scan (state-space dual, single B/C group), the port of
``repro/kernels/ssd_scan.py``.

``ssd_scan`` keeps the reference's layouts (x [b, s, h, p], dt [b, s, h],
A [h], B/C [b, s, n]) and returns what the plain version ``ref.ssd_ref``
returns: (y [b, s, h, p] in x's dtype, final state [b, h, p, n] f32).  On a
CPU tensor it runs ``ref.ssd_ref``; on a CUDA tensor it launches the
hand-written kernel ``csrc/ssd_scan.cu`` (three device kernels: each chunk's
end state, the carry from chunk to chunk, y) or raises.
``ssd_scan.launches`` counts the calls that launched it (not those inside a
CUDA graph capture, which launch nothing).
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import ref as R
from repro_torch.kernels._build import load_library
from repro_torch.kernels.guard import refuse_autograd

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_CHUNK = 128
MAX_STATE = 128
_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = load_library("ssd_scan")
    if not getattr(lib, "_repro_bound", False):
        lib.ssd_scan_fwd.argtypes = [_I] + [_P] * 9 + [_I] * 6 + [_P]
        lib.ssd_scan_fwd.restype = _I
        lib.ssd_scan_error_string.argtypes = [_I]
        lib.ssd_scan_error_string.restype = ctypes.c_char_p
        lib._repro_bound = True
    return lib


def _check(x, dt, A, B, C, chunk: int):
    """What the kernel takes: x, B and C float32 or bfloat16 (one dtype),
    dt and A float32, all contiguous on one card; chunk in 1..128 dividing
    s; n <= 128."""
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"ssd_scan kernel takes float32 or bfloat16 x, not "
                        f"{x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"need x [b,s,h,p], got {tuple(x.shape)}")
    b, s, h, p = x.shape
    n = B.shape[-1] if B.dim() == 3 else -1
    want = {"dt": ((b, s, h), torch.float32), "A": ((h,), torch.float32),
            "B": ((b, s, n), x.dtype), "C": ((b, s, n), x.dtype)}
    got = {"dt": dt, "A": A, "B": B, "C": C}
    for name, (shape, dtype) in want.items():
        t = got[name]
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                             f"{shape}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    for name, t in [("x", x)] + [(k, got[k]) for k in want]:
        if not t.is_contiguous():
            raise ValueError(f"{name}: need a contiguous tensor, got strides "
                             f"{t.stride()}")
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"chunk {chunk} not in 1..{MAX_CHUNK}")
    if s % chunk:
        raise ValueError(f"sequence length {s} is not a multiple of the "
                         f"chunk {chunk}")
    if not 1 <= n <= MAX_STATE:
        raise ValueError(f"state width {n} not in 1..{MAX_STATE}")
    if b > 65535 or h > 65535:
        raise ValueError("too many batch rows or heads for one launch")


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, chunk: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [b,s,h,p]; dt: [b,s,h]; A: [h]; B, C: [b,s,n] -> (y [b,s,h,p],
    final_state [b,h,p,n] f32), from a zero initial state.  s must be a
    multiple of ``chunk``; padded steps with dt = 0 leave the state
    unchanged.  Raises under autograd (``kernels/guard.py``): SSD-family
    training takes the plain scan (``mamba_forward``'s train route)."""
    refuse_autograd("ssd_scan", x, dt, A, B, C,
                    note="; SSD-family (ssm / hybrid) training takes the "
                         "plain ref.ssd_ref (models/mamba.py::mamba_forward"
                         ", train=True)")
    if x.device.type == "cpu":
        return R.ssd_ref(x, dt, A, B, C, chunk)
    _check(x, dt, A, B, C, chunk)
    b, s, h, p = x.shape
    n = B.shape[-1]
    y = torch.empty_like(x)
    f32 = dict(dtype=torch.float32, device=x.device)
    state = torch.empty((b, h, p, n), **f32)
    # scratch: each chunk's end state, then (over it) the state before the
    # chunk; the prefix sums of dt * A
    states = torch.empty((b, s // chunk, h, p, n), **f32)
    cum = torch.empty((b, h, s), **f32)
    lib = _lib()
    rc = lib.ssd_scan_fwd(
        _DTYPE_CODE[x.dtype], x.data_ptr(), dt.data_ptr(), A.data_ptr(),
        B.data_ptr(), C.data_ptr(), states.data_ptr(), cum.data_ptr(),
        y.data_ptr(), state.data_ptr(), b, s, h, p, n, chunk,
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc:
        msg = lib.ssd_scan_error_string(rc).decode()
        raise RuntimeError(f"ssd_scan launch failed: {msg} ({rc})")
    if not torch.cuda.is_current_stream_capturing():
        ssd_scan.launches += 1
    return y, state


ssd_scan.launches = 0
