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
launched the kernel (not those inside a capture, which launch nothing),
and ``decode_attention.shapes`` the same calls by head shape (H, Hkv, D).

What the kernel takes: float32 or bfloat16, any head dim D >= 1
(``flash_attention.check_head_dim``), H any multiple of Hkv, unit stride
over D, any S; ``route`` names the instance a call runs in.  A D that is a
multiple of 8 from 8 to 256 with k and v 16-byte aligned (pointers and
their other strides; every served shape) runs in the TMA instances above
("tma"), in the smallest of their widths that holds D (zero-filled past D
inside their own loads; more than 16 q heads per kv head run as clusters of
16 rows each: granite-20b's 48 : 1 three, falcon-7b's 71 : 1 five).  In
bf16 any other D up to 256 or stride runs in the same tensor-core kernel
with its K and V tiles filled by narrow copies of
``flash_attention.piece_bytes`` ("narrow"), any D past 256 in its wide
instance (128-column output slices, Q K^T in 128-column pieces; "wide"),
and f32 at any other D or stride in the CUDA-core instance
(``csrc/attention_any.cuh``: one block per row, kv head and group of 8 q
heads walks the live keys, output columns in slices of 128; "any").  The
lengths stay on the device (nothing here reads them back) and must lie in
[1, S]; the kernel reads only keys [0, min(length, S)).  The reference's
``S % block_k == 0`` assert is a TPU tiling rule and is not carried over.
"""
from __future__ import annotations

import collections
import ctypes
import math

import torch

from repro_torch.kernels import ref as R
from repro_torch.kernels._build import load_library
from repro_torch.kernels.flash_attention import _aligned, check_head_dim
from repro_torch.kernels.guard import refuse_autograd

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = load_library("decode_attention")
    if not getattr(lib, "_repro_bound", False):
        lib.decode_attention_fwd.argtypes = [
            _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
            ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, _P]
        lib.decode_attention_fwd.restype = _I
        lib.decode_attention_route.argtypes = [
            _I, _P, _P, _I, ctypes.POINTER(ctypes.c_longlong)]
        lib.decode_attention_route.restype = _I
        lib.decode_attention_splits.argtypes = [_I]
        lib.decode_attention_splits.restype = _I
        lib.decode_attention_error_string.argtypes = [_I]
        lib.decode_attention_error_string.restype = ctypes.c_char_p
        lib._repro_bound = True
    return lib


def route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """Which instance of ``csrc/decode_attention.cu`` runs a call, as its
    entry point chooses: "tma" where D is a multiple of 8 from 8 to 256 and
    k's and v's pointers and strides are 16-byte aligned (bf16: mma.sync
    fed by TMA; f32: FMA); else bf16 "narrow" (D up to 256: the same
    mma.sync kernel, its tiles filled by narrow copies of
    ``flash_attention.piece_bytes``) or "wide" (any D past 256), and f32
    "any" (the CUDA-core instance).  No instance reads q by TMA: its
    strides choose nothing."""
    D = q.shape[-1]
    if D % 8 == 0 and D <= 256 and _aligned(k) and _aligned(v):
        return "tma"
    if q.dtype == torch.bfloat16:
        return "narrow" if D <= 256 else "wide"
    return "any"


_ROUTES = ("tma", "narrow", "wide", "any")


def _strides(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    return (ctypes.c_longlong * 8)(*q.stride()[:2], *k.stride()[:3],
                                   *v.stride()[:3])


def kernel_route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The instance the kernel's entry point picks for these CUDA tensors
    (``decode_attention_route``, the decision ``decode_attention_fwd``
    takes), named as ``route`` names it."""
    code = _lib().decode_attention_route(
        _DTYPE_CODE[q.dtype], k.data_ptr(), v.data_ptr(), q.shape[-1],
        _strides(q, k, v))
    if code < 0:
        raise ValueError(f"decode_attention takes no {q.dtype} head dim "
                         f"{q.shape[-1]}")
    return _ROUTES[code]


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
    check_head_dim(D)
    Hkv = k.shape[2]
    if H % Hkv:
        raise ValueError(f"{H} q heads are not a multiple of {Hkv} kv "
                         f"heads")
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


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
    """q: [B, H, D]; k/v: [B, S, Hkv, D]; lengths: [B] int -> [B, H, D] in
    q's dtype.  q head h reads kv head h // (H // Hkv).  Raises under
    autograd (``kernels/guard.py``)."""
    refuse_autograd("decode_attention", q, k, v)
    if q.device.type == "cpu":
        return R.decode_attention_ref(q, k, v, lengths)
    _check(q, k, v, lengths)
    B, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    lib = _lib()
    out = torch.empty((B, H, D), dtype=q.dtype, device=q.device)
    strides = _strides(q, k, v)
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
        decode_attention.shapes[(H, Hkv, D)] += 1
    return out


decode_attention.launches = 0
decode_attention.shapes = collections.Counter()
