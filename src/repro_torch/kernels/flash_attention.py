"""Flash attention (prefill): blocked online-softmax attention with causal
and sliding-window masking and GQA, the port of
``repro/kernels/flash_attention.py``.

``flash_attention`` keeps the reference's public layout and signature
(q [B, Sq, H, D], k/v [B, Skv, Hkv, D] -> [B, Sq, H, D]; ``causal``,
``window``, ``block_q``, ``block_k``) and its precondition: each sequence
length must be a multiple of its block, capped at the length.  On a CUDA
tensor it launches the hand-written kernel ``csrc/flash_attention.cu`` at
any head dim D >= 1 and any number of q heads per kv head (``route``): a D
that is a multiple of 8 from 8 to 256 with 16-byte aligned rows (every
served shape) in its TMA instances (bf16: 128 x 128 tiles loaded by TMA
into a wgmma pipeline, 128 x 64 at D > 128; f32: 64 x 64 tiles on FMA;
each in the smallest of its instance widths that holds D, zero-filled past
D inside its own loads).  In bf16 any other D up to 256 or stride runs in
the same wgmma kernel with its tiles filled by narrow copies, and D past
256 in its wide instance (wgmma, 128-column output slices); in f32 they
run in the CUDA-core instance (``csrc/attention_any.cuh``).  The kernel
tiles itself, the blocks only fix the precondition.  On a
CPU tensor it runs the plain version ``ref.flash_attention_ref`` with the
reference's blocks.  A launch or a tensor-map encode that fails raises.
``flash_attention.launches`` counts the launches (not a call inside a CUDA
graph capture, which launches nothing), and ``flash_attention.shapes`` the
same launches by head shape (H, Hkv, D).
"""
from __future__ import annotations

import collections
import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import ref as R
from repro_torch.kernels._build import load_library
from repro_torch.kernels.guard import refuse_autograd

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
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
        lib.flash_attention_route.argtypes = [
            _I, _P, _P, _P, _I, ctypes.POINTER(ctypes.c_longlong)]
        lib.flash_attention_route.restype = _I
        lib.flash_attention_error_string.argtypes = [_I]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        lib._repro_bound = True
    return lib


def check_head_dim(D: int):
    """Raise ``ValueError`` for a head dim the attention kernels do not
    take: anything below 1."""
    if D < 1:
        raise ValueError(f"head dim {D}: the attention kernels take any "
                         f"head dim from 1")


def _aligned(t: torch.Tensor) -> bool:
    """16-byte pointer and (batch, sequence, head) strides: TMA reads it."""
    el = t.element_size()
    return t.data_ptr() % 16 == 0 and all(s * el % 16 == 0
                                          for s in t.stride()[:3])


def piece_bytes(t: torch.Tensor) -> int:
    """The widest piece, in bytes, in which the narrow copies read bf16
    rows of ``t`` [B, S, H, D]: 16, 8 or 4 where it divides D's bytes, the
    strides' and the pointer, else 2 (``csrc/hopper.cuh::piece_elems``)."""
    for n in (16, 8, 4):
        if t.data_ptr() % n == 0 and all(
                s * 2 % n == 0 for s in (t.shape[3], *t.stride()[:3])):
            return n
    return 2


def route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """Which instance of ``csrc/flash_attention.cu`` runs a call, as its
    entry point chooses: "tma" where D is a multiple of 8 from 8 to 256 and
    every pointer and stride is 16-byte aligned (bf16: wgmma fed by TMA;
    f32: FMA); else bf16 "narrow" (D up to 256: the same wgmma kernel, its
    tiles filled by narrow copies of ``piece_bytes``) or "wide" (D past
    256), and f32 "any" (the CUDA-core instance)."""
    D = q.shape[-1]
    if D % 8 == 0 and D <= 256 and all(_aligned(t) for t in (q, k, v)):
        return "tma"
    if q.dtype == torch.bfloat16:
        return "narrow" if D <= 256 else "wide"
    return "any"


_ROUTES = ("tma", "narrow", "wide", "any")


def _strides(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    return (ctypes.c_longlong * 9)(*q.stride()[:3], *k.stride()[:3],
                                   *v.stride()[:3])


def kernel_route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The instance the kernel's entry point picks for these CUDA tensors
    (``flash_attention_route``, the decision ``flash_attention_fwd``
    takes), named as ``route`` names it."""
    code = _lib().flash_attention_route(
        _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        q.shape[-1], _strides(q, k, v))
    if code < 0:
        raise ValueError(f"flash_attention takes no {q.dtype} head dim "
                         f"{q.shape[-1]}")
    return _ROUTES[code]


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """What the kernel takes: float32 or bfloat16 on one card, the same
    dtype throughout, any D >= 1 (``check_head_dim``), H a multiple of Hkv,
    unit stride over D (any other strides and pointers: ``route``)."""
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
    check_head_dim(D)
    if H % k.shape[2]:
        raise ValueError(f"{H} q heads are not a multiple of {k.shape[2]} "
                         f"kv heads")
    if B * H > 65535:
        raise ValueError("too many (batch, head) pairs for one launch")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{name}: need unit stride over D, got strides "
                             f"{t.stride()}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    block_q: int = 128, block_k: int = 128) -> torch.Tensor:
    """q: [B, Sq, H, D]; k/v: [B, Skv, Hkv, D] -> [B, Sq, H, D] in q's
    dtype.  q head h reads kv head h // (H // Hkv); query i sits at
    absolute position i + Skv - Sq.  Raises under autograd
    (``kernels/guard.py``): train with ``attn_impl="xla"``, as the
    reference does."""
    refuse_autograd("flash_attention", q, k, v,
                    note='; train with attn_impl="xla"')
    R.flash_blocks(q.shape[1], k.shape[1], block_q, block_k)
    if q.device.type == "cpu":
        return R.flash_attention_ref(q, k, v, causal=causal, window=window,
                                     block_q=block_q, block_k=block_k)
    _check(q, k, v)
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    strides = _strides(q, k, v)
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
        flash_attention.shapes[(H, Hkv, D)] += 1
    return out


flash_attention.launches = 0
flash_attention.shapes = collections.Counter()
