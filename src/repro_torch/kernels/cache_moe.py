"""Slot-indexed grouped MoE FFN over the ExpertCache slot pool.

Computes, for the verify block's tokens x [T, d] and their routed slots
slot_ids [T, k] (-1 = miss or masked out of this wave),

    y[t] = sum_c  w[t, c] * FFN_{slot_ids[t, c]}(x[t])        (slot >= 0)

with FFN_s(x) = (silu(x @ wg[s]) * (x @ wu[s])) @ wd[s] for swiglu experts
and gelu_tanh(x @ wu[s]) @ wd[s] for gelu experts (``wg=None``).  Index prep
is fixed-shape torch ops on the device (``slot_groups``): no host sync, so
the fast verify path keeps its ≤2-syncs-per-block contract.  The two GEMM
stages are the hand-written CUDA kernel ``csrc/cache_moe.cu`` (``gate_up`` or
``up_gelu``, then ``down``), which reads the weights straight out of the
[S, ...] slot pool.  bf16 runs on the tensor cores at every width (a ring
of weight tiles feeding wgmma row products): the tiles come by TMA and the
rows in 16-byte copies where every row is a whole number of 16 bytes from a
16-byte aligned pointer (every served width), else by narrow copies of the
widest piece each tensor allows (8, 4 or 2 bytes), into the same tiles for
the same products (``_route``).  f32 runs on FMA, the weights loaded in
16-byte pieces where the rows allow it, else element by element.  The
combine is in f32, in each token's choice order, outside the kernel (as the
reference keeps it outside Pallas).

Each wrapper takes the kernel's plain version (``kernels/ref.py``) only when
its input lies on the CPU; on a CUDA tensor it launches the kernel or raises.
Under autograd every wrapper raises, on the CPU too (``kernels/guard.py``).
``gate_up.launches`` / ``up_gelu.launches`` / ``down.launches`` count the
launches, and their ``shapes`` the same launches by expert width (d, f); a
call inside a CUDA graph capture records its kernel into the graph and
launches nothing, so it does not count there but in ``captured`` (each
replay of that graph launches the kernel again).
"""
from __future__ import annotations

import collections
import ctypes
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import ref as R
from repro_torch.kernels._build import load_library
from repro_torch.kernels.guard import refuse_autograd

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = load_library("cache_moe")
    if not getattr(lib, "_repro_bound", False):
        lib.cache_moe_gate_up.argtypes = [_I, _P, _P, _P, _P, _P, _P, _P, _P,
                                          _I, _I, _I, _I, _I, _P]
        lib.cache_moe_gate_up.restype = _I
        lib.cache_moe_up_gelu.argtypes = [_I, _P, _P, _P, _P, _P, _P, _P,
                                          _I, _I, _I, _I, _I, _P]
        lib.cache_moe_up_gelu.restype = _I
        lib.cache_moe_down.argtypes = [_I, _P, _P, _P, _P, _P, _P, _I, _I,
                                       _I, _I, _I, _P]
        lib.cache_moe_down.restype = _I
        lib.cache_moe_route.argtypes = [_P, _P, _P, _I, _I,
                                        ctypes.POINTER(_I),
                                        ctypes.POINTER(_I)]
        lib.cache_moe_route.restype = _I
        lib.cache_moe_error_string.argtypes = [_I]
        lib.cache_moe_error_string.restype = ctypes.c_char_p
        lib._repro_bound = True
    return lib


class SlotGroups(NamedTuple):
    """Choices sorted by slot, grouped per occupied slot (all int32 on the
    device; fixed shapes: ``M = min(S, T·k)`` groups, ``P = T·k`` rows).

    grp_slot/grp_start/grp_count [M]: group g's slot and its rows
    [start, start + count) of the sorted order (count 0 = unused group);
    row_tok [P]: the token of each sorted row; inv [P] (int64): the sorted
    row of each flat choice t·k + c; valid [T, k]: slot_ids >= 0."""
    grp_slot: torch.Tensor
    grp_start: torch.Tensor
    grp_count: torch.Tensor
    row_tok: torch.Tensor
    inv: torch.Tensor
    valid: torch.Tensor


def slot_groups(slot_ids: torch.Tensor, num_slots: int) -> SlotGroups:
    """Sync-free dispatch of [T, k] slot ids over a pool of ``num_slots``.

    Misses sort last (into an overflow group that no kernel block reads).
    Occupancy comes from a ``scatter_add_`` into zeros, dense group ranks from
    a ``cumsum``, and the per-group tables from scatters into buffers one row
    larger (the extra row takes the unoccupied slots and is sliced off)."""
    T, k = slot_ids.shape
    P = T * k
    M = min(num_slots, P)
    dev = slot_ids.device
    i64 = torch.int64
    flat = slot_ids.reshape(-1).to(i64)
    valid = flat >= 0
    sane = torch.where(valid, flat, torch.full_like(flat, num_slots))
    order = torch.sort(sane, stable=True).indices
    counts = torch.zeros(num_slots + 1, dtype=i64, device=dev
                         ).scatter_add_(0, sane, torch.ones_like(sane))
    starts = torch.cumsum(counts, 0) - counts
    occ = counts[:num_slots] > 0
    rank = torch.cumsum(occ.to(i64), 0) - 1
    dst = torch.where(occ, rank, torch.full_like(rank, M))

    def table(src: torch.Tensor) -> torch.Tensor:
        buf = torch.zeros(M + 1, dtype=i64, device=dev).scatter_(0, dst, src)
        return buf[:M].to(torch.int32)

    inv = torch.empty_like(order).scatter_(
        0, order, torch.arange(P, dtype=i64, device=dev))
    return SlotGroups(
        grp_slot=table(torch.arange(num_slots, dtype=i64, device=dev)),
        grp_start=table(starts[:num_slots]),
        grp_count=table(counts[:num_slots]),
        row_tok=(order // k).to(torch.int32),
        inv=inv,
        valid=valid.reshape(T, k))


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, ndim: int,
           aligned: bool):
    """``aligned``: the route reads ``t`` in 16-byte pieces from its own
    pointer on (f32 weights: it must be 16-byte aligned)."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.dim() != ndim or not t.is_contiguous():
        raise ValueError(f"{name}: need a contiguous {ndim}-d tensor, got "
                         f"shape {tuple(t.shape)}")
    if aligned and t.data_ptr() % 16:
        raise ValueError(f"{name}: data pointer is not 16-byte aligned")


def _piece(t: torch.Tensor, width: int) -> int:
    """The widest piece, in bytes, in which the tensor-core body copies bf16
    rows of ``width`` elements from ``t``: 16, 8 or 4 where it divides a
    row's bytes and the pointer, else 2 (``csrc/hopper.cuh::piece_elems``).
    """
    for n in (16, 8, 4):
        if width * 2 % n == 0 and t.data_ptr() % n == 0:
            return n
    return 2


def _route(x: torch.Tensor, weights, K: int, N: int):
    """How the kernel runs a [K] -> [N] stage on the rows ``x`` and the
    slot pools ``weights``: (body, the rows' piece, the weights' piece),
    pieces in bytes, as ``csrc/cache_moe.cu`` chooses them.  bf16 runs on
    the tensor cores at every width, "tma" (the weights by TMA, the rows in
    16-byte copies) where both pieces are 16 bytes, else "narrow" (every
    tile by the narrow copies); the body is the dtype's alone, so each
    output's sum is a function of K and N, and the pieces change no bit.
    f32 runs on "fma": rows element by element, weights in 16-byte loads at
    N a multiple of 4 (from a 16-byte aligned pointer), else element by
    element."""
    if x.dtype == torch.bfloat16:
        rows = _piece(x, K)
        wts = min(_piece(w, N) for w in weights)
        return ("tma" if rows == wts == 16 else "narrow"), rows, wts
    return "fma", 4, 16 if N % 4 == 0 else 4


def kernel_route(x: torch.Tensor, weights, K: int, N: int):
    """``_route`` as the kernel decides it for bf16 CUDA tensors
    (``cache_moe_route``, the decision its entry points take)."""
    rows, wts = _I(), _I()
    w1, w2 = (*weights, None)[:2]
    code = _lib().cache_moe_route(x.data_ptr(), w1.data_ptr(),
                                  None if w2 is None else w2.data_ptr(), K,
                                  N, ctypes.byref(rows), ctypes.byref(wts))
    return ("tma", "narrow")[code], rows.value, wts.value


def _vector_weights(route) -> bool:
    """Whether the route reads the weights in 16-byte pieces from their own
    pointer (f32 at N a multiple of 4: ``_check`` asks alignment)."""
    return route[0] == "fma" and route[2] == 16


def _check_call(x: torch.Tensor, g: SlotGroups, *weights: torch.Tensor):
    """What both stages take: float32 or bfloat16 on the input's device,
    any width, contiguous int32 groups."""
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"cache_moe kernel takes float32 or bfloat16, "
                        f"not {x.dtype}")
    for w in weights:
        if w.device != x.device:
            raise ValueError("weights and activations on different devices")
    for name in ("grp_slot", "grp_start", "grp_count", "row_tok"):
        t = getattr(g, name)
        if t.dtype != torch.int32 or not t.is_contiguous() \
                or t.device != x.device:
            raise ValueError(f"{name}: need contiguous int32 on {x.device}")
    if g.grp_slot.shape[0] > 65535:
        raise ValueError("too many slot groups for one launch")


def _raise(lib: ctypes.CDLL, what: str, rc: int):
    if rc:
        msg = lib.cache_moe_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: {msg} ({rc})")


def gate_up(x: torch.Tensor, g: SlotGroups, wg: torch.Tensor,
            wu: torch.Tensor) -> torch.Tensor:
    """Stage 1: h [T·k, f], h[p] = silu(x[row] @ wg[s]) * (x[row] @ wu[s])
    for each sorted row p of each group (rows of no group are 0)."""
    refuse_autograd("cache_moe_gate_up", x, wg, wu)
    if x.device.type == "cpu":
        return R.slot_gate_up_ref(x, g.row_tok, wg, wu, g.grp_slot,
                                  g.grp_start, g.grp_count)
    _check_call(x, g, wg, wu)
    d, f = x.shape[-1], wg.shape[-1]
    vec = _vector_weights(_route(x, (wg, wu), d, f))
    _check("x", x, x.dtype, 2, False)
    _check("wg", wg, x.dtype, 3, vec)
    _check("wu", wu, x.dtype, 3, vec)
    if wg.shape[1] != d or wu.shape != wg.shape:
        raise ValueError(f"gate_up shapes: x {tuple(x.shape)}, "
                         f"wg {tuple(wg.shape)}, wu {tuple(wu.shape)}")
    h = torch.zeros((g.row_tok.shape[0], f), dtype=x.dtype, device=x.device)
    lib = _lib()
    rc = lib.cache_moe_gate_up(
        _DTYPE_CODE[x.dtype], x.data_ptr(), g.row_tok.data_ptr(),
        wg.data_ptr(), wu.data_ptr(), g.grp_slot.data_ptr(),
        g.grp_start.data_ptr(), g.grp_count.data_ptr(), h.data_ptr(),
        d, f, wg.shape[0], g.row_tok.shape[0], g.grp_slot.shape[0],
        torch.cuda.current_stream(x.device).cuda_stream)
    _raise(lib, "cache_moe_gate_up", rc)
    if torch.cuda.is_current_stream_capturing():
        gate_up.captured += 1
    else:
        gate_up.launches += 1
        gate_up.shapes[(d, f)] += 1
    return h


gate_up.launches = 0
gate_up.captured = 0
gate_up.shapes = collections.Counter()


def up_gelu(x: torch.Tensor, g: SlotGroups, wu: torch.Tensor) -> torch.Tensor:
    """Stage 1 of gelu experts: h [T·k, f], h[p] = gelu_tanh(x[row] @ wu[s])
    for each sorted row p of each group (rows of no group are 0)."""
    refuse_autograd("cache_moe_up_gelu", x, wu)
    if x.device.type == "cpu":
        return R.slot_up_gelu_ref(x, g.row_tok, wu, g.grp_slot, g.grp_start,
                                  g.grp_count)
    _check_call(x, g, wu)
    d, f = x.shape[-1], wu.shape[-1]
    _check("x", x, x.dtype, 2, False)
    _check("wu", wu, x.dtype, 3, _vector_weights(_route(x, (wu,), d, f)))
    if wu.shape[1] != d:
        raise ValueError(f"up_gelu shapes: x {tuple(x.shape)}, "
                         f"wu {tuple(wu.shape)}")
    h = torch.zeros((g.row_tok.shape[0], f), dtype=x.dtype, device=x.device)
    lib = _lib()
    rc = lib.cache_moe_up_gelu(
        _DTYPE_CODE[x.dtype], x.data_ptr(), g.row_tok.data_ptr(),
        wu.data_ptr(), g.grp_slot.data_ptr(), g.grp_start.data_ptr(),
        g.grp_count.data_ptr(), h.data_ptr(), d, f, wu.shape[0],
        g.row_tok.shape[0], g.grp_slot.shape[0],
        torch.cuda.current_stream(x.device).cuda_stream)
    _raise(lib, "cache_moe_up_gelu", rc)
    if torch.cuda.is_current_stream_capturing():
        up_gelu.captured += 1
    else:
        up_gelu.launches += 1
        up_gelu.shapes[(d, f)] += 1
    return h


up_gelu.launches = 0
up_gelu.captured = 0
up_gelu.shapes = collections.Counter()


def down(h: torch.Tensor, g: SlotGroups, wd: torch.Tensor) -> torch.Tensor:
    """Stage 2: y [T·k, d], y[p] = h[p] @ wd[s] for each sorted row p of
    each group (rows of no group are 0), in h's dtype."""
    refuse_autograd("cache_moe_down", h, wd)
    if h.device.type == "cpu":
        return R.slot_down_ref(h, wd, g.grp_slot, g.grp_start, g.grp_count)
    _check_call(h, g, wd)
    f, d = h.shape[-1], wd.shape[-1]
    _check("h", h, h.dtype, 2, False)
    _check("wd", wd, h.dtype, 3, _vector_weights(_route(h, (wd,), f, d)))
    if wd.shape[1] != f:
        raise ValueError(f"down shapes: h {tuple(h.shape)}, "
                         f"wd {tuple(wd.shape)}")
    y = torch.zeros((h.shape[0], d), dtype=h.dtype, device=h.device)
    lib = _lib()
    rc = lib.cache_moe_down(
        _DTYPE_CODE[h.dtype], h.data_ptr(), wd.data_ptr(),
        g.grp_slot.data_ptr(), g.grp_start.data_ptr(),
        g.grp_count.data_ptr(), y.data_ptr(), f, d, wd.shape[0],
        g.row_tok.shape[0], g.grp_slot.shape[0],
        torch.cuda.current_stream(h.device).cuda_stream)
    _raise(lib, "cache_moe_down", rc)
    if torch.cuda.is_current_stream_capturing():
        down.captured += 1
    else:
        down.launches += 1
        down.shapes[(d, f)] += 1
    return y


down.launches = 0
down.captured = 0
down.shapes = collections.Counter()


def cache_moe(x: torch.Tensor, slot_ids: torch.Tensor, weights: torch.Tensor,
              wu: torch.Tensor, wd: torch.Tensor,
              wg: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: [T, d]; slot_ids/weights: [T, k]; wu/wg: [S, d, f]; wd: [S, f, d]
    -> y [T, d].  slot_ids < 0 contribute zero; ``wg=None`` means gelu
    experts."""
    T, k = slot_ids.shape
    g = slot_groups(slot_ids, wu.shape[0])
    h = up_gelu(x, g, wu) if wg is None else gate_up(x, g, wg, wu)
    yc = down(h, g, wd)
    per = yc[g.inv].reshape(T, k, x.shape[1]).float()
    w = torch.where(g.valid, weights.float(),
                    torch.zeros((), dtype=torch.float32, device=x.device))
    return (per * w[..., None]).sum(dim=1).to(x.dtype)
