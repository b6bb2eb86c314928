"""Flash attention (prefill): blocked online-softmax attention with causal
and sliding-window masking and GQA, the port of
``repro/kernels/flash_attention.py``.

``flash_attention`` keeps the reference's public layout and signature
(q [B, Sq, H, D], k/v [B, Skv, Hkv, D] -> [B, Sq, H, D]; ``causal``,
``window``, ``block_q``, ``block_k``) and its precondition: each sequence
length must be a multiple of its block, capped at the length.  On a CUDA
tensor it launches the hand-written kernel ``csrc/flash_attention.cu``
(bf16: 128 x 128 tiles loaded by TMA into a wgmma pipeline, 128 x 64 at
D 192; f32: 64 x 64 tiles on FMA; the kernel tiles itself, the blocks only
fix the precondition), on a CPU tensor it runs the plain version
``ref.flash_attention_ref`` with the reference's blocks.  A launch or a
tensor-map encode that fails raises.  ``flash_attention.launches`` counts
the launches (not a call inside a CUDA graph capture, which launches
nothing).
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import ref as R
from repro_torch.kernels._build import load_library

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_VEC = {torch.float32: 4, torch.bfloat16: 8}   # elements per 16-byte load
HEAD_DIMS = (16, 32, 64, 112, 128, 192)   # 112: zamba2-7b, 192: nemotron
_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = load_library("flash_attention")
    if not getattr(lib, "_repro_bound", False):
        lib.flash_attention_fwd.argtypes = [
            _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
            ctypes.POINTER(ctypes.c_longlong), _I, _I, _I, ctypes.c_float,
            _P]
        lib.flash_attention_fwd.restype = _I
        lib.flash_attention_error_string.argtypes = [_I]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        lib._repro_bound = True
    return lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """What the kernel takes: float32 or bfloat16 on one card, the same
    dtype throughout, D in HEAD_DIMS, H a multiple of Hkv, unit stride over
    D, the other strides and the data pointers 16-byte aligned."""
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash_attention kernel takes float32 or bfloat16, "
                        f"not {q.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise TypeError(f"{name}: dtype {t.dtype}, q is {q.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"need q [B,Sq,H,D] and k/v [B,Skv,Hkv,D], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, _, H, D = q.shape
    if k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ "
                         f"in batch or head dim")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {HEAD_DIMS}")
    if H % k.shape[2]:
        raise ValueError(f"{H} q heads are not a multiple of {k.shape[2]} "
                         f"kv heads")
    if B * H > 65535:
        raise ValueError("too many (batch, head) pairs for one launch")
    vec = _VEC[q.dtype]
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1 or any(s % vec for s in t.stride()[:3]):
            raise ValueError(f"{name}: need unit stride over D and 16-byte "
                             f"aligned rows, got strides {t.stride()}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: data pointer is not 16-byte aligned")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    block_q: int = 128, block_k: int = 128) -> torch.Tensor:
    """q: [B, Sq, H, D]; k/v: [B, Skv, Hkv, D] -> [B, Sq, H, D] in q's
    dtype.  q head h reads kv head h // (H // Hkv); query i sits at
    absolute position i + Skv - Sq."""
    R.flash_blocks(q.shape[1], k.shape[1], block_q, block_k)
    if q.device.type == "cpu":
        return R.flash_attention_ref(q, k, v, causal=causal, window=window,
                                     block_q=block_q, block_k=block_k)
    _check(q, k, v)
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 9)(*q.stride()[:3], *k.stride()[:3],
                                      *v.stride()[:3])
    lib = _lib()
    rc = lib.flash_attention_fwd(
        _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), B, Sq, Skv, H, Hkv, D, strides, int(causal),
        int(window is not None), 0 if window is None else int(window),
        ctypes.c_float(1.0 / math.sqrt(D)),
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc:
        msg = lib.flash_attention_error_string(rc).decode()
        raise RuntimeError(f"flash_attention launch failed: {msg} ({rc})")
    if not torch.cuda.is_current_stream_capturing():
        flash_attention.launches += 1
    return out


flash_attention.launches = 0
