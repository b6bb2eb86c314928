"""Mamba2 chunked SSD scan (state-space dual, single B/C group), the port of
``repro/kernels/ssd_scan.py``.

``ssd_scan`` keeps the reference's layouts (x [b, s, h, p], dt [b, s, h],
A [h], B/C [b, s, n]) and returns what the plain version ``ref.ssd_ref``
returns: (y [b, s, h, p] in x's dtype, final state [b, h, p, n] f32), from
``init_state`` [b, h, p, n] f32 or from zero.  On a CPU tensor it runs
``ref.ssd_ref``; on a CUDA tensor it launches the hand-written kernel
``csrc/ssd_scan.cu`` (three device kernels: each tile's end state, the
carry from tile to tile, y) or raises.  It takes any chunk that divides s
and any state width n: the kernel scans in tiles of the chunk up to 128
rows, else of 128 rows with a ragged last tile (``ssd_scan_tile``; the
result depends on the chunk only through rounding), and a state wider than
128 in blocks of 128 columns (the kernels' sliced instance).
``ssd_scan.launches`` counts the calls that launched it (not those inside a
CUDA graph capture, which launch nothing), and ``ssd_scan.shapes`` the same
calls by (chunk, state width n).
"""
from __future__ import annotations

import collections
import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import ref as R
from repro_torch.kernels._build import load_library
from repro_torch.kernels.guard import refuse_autograd

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = load_library("ssd_scan")
    if not getattr(lib, "_repro_bound", False):
        lib.ssd_scan_fwd.argtypes = [_I] + [_P] * 10 + [_I] * 6 + [_P]
        lib.ssd_scan_fwd.restype = _I
        lib.ssd_scan_tile.argtypes = [_I]
        lib.ssd_scan_tile.restype = _I
        lib.ssd_scan_error_string.argtypes = [_I]
        lib.ssd_scan_error_string.restype = ctypes.c_char_p
        lib._repro_bound = True
    return lib


def _check(x, dt, A, B, C, chunk: int, init_state):
    """What the kernel takes: x, B and C float32 or bfloat16 (one dtype),
    dt, A and the initial state float32, all contiguous on one card; any
    chunk >= 1 that divides s; any n."""
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
    if init_state is not None:
        want["init_state"] = ((b, h, p, n), torch.float32)
        got["init_state"] = init_state
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
    if chunk < 1:
        raise ValueError(f"chunk {chunk} is not positive")
    if s % chunk:
        raise ValueError(f"sequence length {s} is not a multiple of the "
                         f"chunk {chunk}")
    if n < 1:
        raise ValueError(f"state width {n} is not positive")
    if b > 65535 or h > 65535:
        raise ValueError("too many batch rows or heads for one launch")


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, chunk: int,
             init_state: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [b,s,h,p]; dt: [b,s,h]; A: [h]; B, C: [b,s,n] -> (y [b,s,h,p],
    final_state [b,h,p,n] f32), from ``init_state`` [b,h,p,n] (the state
    before the first token; zeros when omitted).  s must be a multiple of
    ``chunk``; padded steps with dt = 0 leave the state unchanged.  Raises
    under autograd (``kernels/guard.py``): SSD-family training takes the
    plain scan (``mamba_forward``'s train route)."""
    refuse_autograd("ssd_scan", x, dt, A, B, C, init_state,
                    note="; SSD-family (ssm / hybrid) training takes the "
                         "plain ref.ssd_ref (models/mamba.py::mamba_forward"
                         ", train=True)")
    if x.device.type == "cpu":
        return R.ssd_ref(x, dt, A, B, C, chunk, init_state)
    _check(x, dt, A, B, C, chunk, init_state)
    b, s, h, p = x.shape
    n = B.shape[-1]
    y = torch.empty_like(x)
    f32 = dict(dtype=torch.float32, device=x.device)
    state = torch.empty((b, h, p, n), **f32)
    lib = _lib()
    tiles = -(-s // lib.ssd_scan_tile(chunk))
    # scratch: each tile's end state, then (over it) the state before the
    # tile; the prefix sums of dt * A
    states = torch.empty((b, tiles, h, p, n), **f32)
    cum = torch.empty((b, h, s), **f32)
    rc = lib.ssd_scan_fwd(
        _DTYPE_CODE[x.dtype], x.data_ptr(), dt.data_ptr(), A.data_ptr(),
        B.data_ptr(), C.data_ptr(),
        None if init_state is None else init_state.data_ptr(),
        states.data_ptr(), cum.data_ptr(), y.data_ptr(), state.data_ptr(),
        b, s, h, p, n, chunk,
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc:
        msg = lib.ssd_scan_error_string(rc).decode()
        raise RuntimeError(f"ssd_scan launch failed: {msg} ({rc})")
    if not torch.cuda.is_current_stream_capturing():
        ssd_scan.launches += 1
        ssd_scan.shapes[(chunk, n)] += 1
    return y, state


ssd_scan.launches = 0
ssd_scan.shapes = collections.Counter()
