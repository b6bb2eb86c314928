"""Flash-decode: one query token per batch row against a long KV cache, the
port of ``repro/kernels/decode_attention.py``.

``decode_attention`` keeps the reference's public layout (q [B, H, D], k/v
[B, S, Hkv, D], lengths [B] -> [B, H, D]; key j of row b is attended iff
j < lengths[b]).  On a CUDA tensor it launches the hand-written kernel
``csrc/decode_attention.cu`` (one launch: a thread-block cluster per
(row, kv head) whose blocks split the cache, at most 16 of them and as many
as S alone sets, merged in a fixed order through distributed shared memory);
on a CPU tensor it runs the plain version ``ref.decode_attention_ref``.  The
call allocates its output only, and its launch shape depends on S and the
widths alone, so a CUDA graph can capture it and replay it with ``lengths``
changed in place.  ``decode_attention.launches`` counts the calls that
launched the kernel (not those inside a capture, which launch nothing).

What the kernel takes: float32 or bfloat16, D in ``HEAD_DIMS`` (112 is
zamba2-7b's, 192 nemotron-4-340b's), H a multiple of Hkv with at most 48 q
heads per kv head (granite-20b's 48 : 1; more than 16 run as clusters of 16
rows each), unit stride over D, k and v
16-byte aligned (pointers and their other strides), any S.  The
lengths stay on the device (nothing here reads them back) and must lie in
[1, S]; the kernel reads only keys [0, min(length, S)).  The reference's
``S % block_k == 0`` assert is a TPU tiling rule and is not carried over.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import ref as R
from repro_torch.kernels._build import load_library

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_VEC = {torch.float32: 4, torch.bfloat16: 8}   # elements per 16-byte load
HEAD_DIMS = (16, 32, 64, 112, 128, 192)
MAX_REP = 48                           # csrc: kMaxRep
_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = load_library("decode_attention")
    if not getattr(lib, "_repro_bound", False):
        lib.decode_attention_fwd.argtypes = [
            _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
            ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, _P]
        lib.decode_attention_fwd.restype = _I
        lib.decode_attention_splits.argtypes = [_I]
        lib.decode_attention_splits.restype = _I
        lib.decode_attention_max_rep.restype = _I
        lib.decode_attention_error_string.argtypes = [_I]
        lib.decode_attention_error_string.restype = ctypes.c_char_p
        if lib.decode_attention_max_rep() != MAX_REP:
            raise RuntimeError("decode_attention.cu and its wrapper disagree "
                               "on kMaxRep")
        lib._repro_bound = True
    return lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           lengths: torch.Tensor):
    """What the kernel takes (see the module docstring); raises
    ``TypeError`` / ``ValueError`` on anything else."""
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"decode_attention kernel takes float32 or bfloat16, "
                        f"not {q.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise TypeError(f"{name}: dtype {t.dtype}, q is {q.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"need q [B,H,D] and k/v [B,S,Hkv,D], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, D = q.shape
    if k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ "
                         f"in batch or head dim")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {HEAD_DIMS}")
    Hkv = k.shape[2]
    if H % Hkv or H // Hkv > MAX_REP:
        raise ValueError(f"{H} q heads over {Hkv} kv heads: need a multiple "
                         f"of at most {MAX_REP}")
    if lengths.shape != (B,) or lengths.dtype != torch.int32 \
            or lengths.device != q.device:
        raise ValueError(f"lengths: need int32 [{B}] on {q.device}, got "
                         f"{lengths.dtype} {tuple(lengths.shape)} on "
                         f"{lengths.device}")
    if not lengths.is_contiguous():
        raise ValueError("lengths: need a contiguous tensor")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: need unit stride over D, got strides "
                             f"{t.stride()}")
    vec = _VEC[q.dtype]
    for name, t in (("k", k), ("v", v)):
        if any(s % vec for s in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(f"{name}: need 16-byte aligned rows, got "
                             f"strides {t.stride()}")


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
    """q: [B, H, D]; k/v: [B, S, Hkv, D]; lengths: [B] int -> [B, H, D] in
    q's dtype.  q head h reads kv head h // (H // Hkv)."""
    if q.device.type == "cpu":
        return R.decode_attention_ref(q, k, v, lengths)
    _check(q, k, v, lengths)
    B, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    lib = _lib()
    out = torch.empty((B, H, D), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 8)(*q.stride()[:2], *k.stride()[:3],
                                      *v.stride()[:3])
    rc = lib.decode_attention_fwd(
        _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), B, S, H, Hkv, D, strides,
        ctypes.c_float(1.0 / math.sqrt(D)),
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc:
        msg = lib.decode_attention_error_string(rc).decode()
        raise RuntimeError(f"decode_attention launch failed: {msg} ({rc})")
    if not torch.cuda.is_current_stream_capturing():
        decode_attention.launches += 1
    return out


decode_attention.launches = 0
