"""MoE FFN block: top-k gating, the drop-free decode routing and the
capacity routing of training.  The port of ``repro/models/moe.py``, all of
it (``init_moe`` is ``transformer.MoE``).

* ``moe_global`` (decode, verify blocks, prefill, short training rows):
  drop-free sorted routing.  Where no gradient is taken it runs the routed
  experts through the expert-FFN kernel, so an MoE draft's steps and a
  resident MoE target's steps make no host sync.  Under autograd (a
  train-mode call whose inputs require grad) the kernels cannot run (they
  have no backward, ``kernels/guard.py``), and the grouped products are
  torch ops, one expert's rows at a time: the counterpart of the
  reference's ``lax.ragged_dot``, which no Pallas kernel computes either.
  This is a route chosen by mode, never a fallback taken on failure.
* ``moe_grouped`` (training): routing and capacity per batch row, the
  reference's GShard-style gather / combine with ``C = ceil(cf·S·k/E)``
  rounded up to 8 and capped at S; choices over capacity are dropped.
  Plain tensor ops, differentiable through the gathers, the combine and
  the gate weights, as in the reference (its ``_expert_ffn`` is three
  einsums outside any Pallas kernel).
* ``moe_forward`` picks between them with the reference's rule.

Expert weights are ``[E, d, f]`` / ``[E, f, d]``; the gate is ``[d, E]`` in
f32.  Shared experts (deepseek) are one swiglu FFN ``p.shared`` of width
``num_shared_experts * moe_d_ff`` that every token runs, added to the routed
sum.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import cache_moe as K
from repro_torch.models.layers import ffn_forward


def gate_topk(gate_w: torch.Tensor, x: torch.Tensor, k: int
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                         torch.Tensor]:
    """x: [..., d] -> (weights [..., k] in x's dtype, ids [..., k],
    probs [..., E], aux).

    Mixtral-style: softmax in f32 over all experts, take top-k,
    renormalise.  aux = switch load-balancing loss."""
    logits = torch.einsum("...d,de->...e", x.float(), gate_w)
    probs = torch.softmax(logits, dim=-1)
    weights, ids = torch.topk(probs, k, dim=-1)
    weights = weights / torch.sum(weights, dim=-1, keepdim=True)
    E = gate_w.shape[-1]
    counts = _expert_counts(ids, E)
    frac = counts / torch.clamp(torch.sum(counts), min=1.0)
    mean_prob = torch.mean(probs.reshape(-1, E), dim=0)
    aux = E * torch.sum(frac * mean_prob)
    return weights.to(x.dtype), ids, probs, aux


def _expert_counts(ids: torch.Tensor, E: int) -> torch.Tensor:
    """[E] f32: how many (token, choice) pairs chose each expert.  Of a
    DTensor, each rank counts its own shard and the counts are a partial
    sum over the mesh dims that split ``ids``."""
    if isinstance(ids, DTensor):
        return DTensor.from_local(
            _expert_counts(ids.to_local(), E), ids.device_mesh,
            [Partial() if isinstance(pl, Shard) else pl
             for pl in ids.placements], run_check=False)
    flat = ids.reshape(-1)
    return torch.zeros(E, dtype=torch.float32, device=ids.device
                       ).index_add_(0, flat, torch.ones_like(
                           flat, dtype=torch.float32))


def _expert_ffn(p, e: int, x: torch.Tensor, activation: str) -> torch.Tensor:
    if activation == "swiglu":
        h = F.silu(x @ p.wg[e]) * (x @ p.wu[e])
    else:
        h = F.gelu(x @ p.wu[e], approximate="tanh")
    return h @ p.wd[e]


def moe_global(p, x: torch.Tensor, cfg: ModelConfig
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decode path: drop-free sorted routing through the slot-indexed expert
    FFN (``kernels/cache_moe.py``) over the layer's own ``[E, d, f]``
    stacks, expert id = slot id.  x: [B, S, d] -> (y, aux).  Under
    autograd the products are ``_ragged_ffn``'s torch ops instead (see the
    module docstring); that route reads the group sizes to the host.

    Otherwise nothing here reads the device from the host: the grouping is
    ``slot_groups`` (fixed shapes) and on a CUDA tensor the two stages are
    the hand-written kernels (on the CPU, their plain versions).  The
    combine is the reference's, in the expert dtype: each routed row times
    its gate weight, added into zeros in each token's ascending expert order
    (the order of the reference's sorted scatter-add); ``cache_moe``, the
    offload runtime's, combines in f32 instead."""
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    T = B * S
    xf = x.reshape(T, d).contiguous()
    weights, ids, _, aux = gate_topk(p.gate, xf, k)
    g = K.slot_groups(ids, E)
    if _takes_grad(p, x):
        ys = _ragged_ffn(p, xf, g, cfg.ffn_activation)
    else:
        h = K.gate_up(xf, g, p.wg, p.wu) if cfg.ffn_activation == "swiglu" \
            else K.up_gelu(xf, g, p.wu)
        ys = K.down(h, g, p.wd)                # [T·k, d], rows by expert
    wf = weights.reshape(-1)
    ys = ys * torch.empty_like(wf).scatter_(0, g.inv, wf)[:, None]
    rows = torch.sort(g.inv.reshape(T, k), dim=1).values
    y = torch.zeros((T, d), dtype=ys.dtype, device=x.device)
    for c in range(k):
        y = y + ys[rows[:, c]]
    y = y.reshape(B, S, d)
    if cfg.num_shared_experts:
        y = y + ffn_forward(p.shared, x, "swiglu")
    return y.to(x.dtype), aux


def _takes_grad(p, x: torch.Tensor) -> bool:
    """Whether autograd records the expert products: grad mode is on and
    the input or an expert stack requires grad."""
    if not torch.is_grad_enabled():
        return False
    return any(t is not None and t.requires_grad
               for t in (x, getattr(p, "wg", None), p.wu, p.wd))


def _ragged_ffn(p, xf: torch.Tensor, g: K.SlotGroups, activation: str
                ) -> torch.Tensor:
    """The grouped products of ``moe_global`` under autograd: each
    expert's sorted rows through its FFN, exactly T·k rows, in the order
    ``K.down`` returns them ([T·k, d], rows by expert)."""
    out = []
    for e, lo, n in zip(g.grp_slot.tolist(), g.grp_start.tolist(),
                        g.grp_count.tolist()):
        if n:
            out.append(_expert_ffn(p, e, xf[g.row_tok[lo:lo + n].long()],
                                   activation))
    return torch.cat(out)


def capacity(cfg: ModelConfig, S: int) -> int:
    """Per-row expert capacity of ``moe_grouped``: ceil(cf·S·k/E), rounded
    up to a multiple of 8, at least 8 and at most S (8 for S < 8)."""
    C = math.ceil(cfg.capacity_factor * S * cfg.num_experts_per_tok
                  / cfg.num_experts)
    return max(8, min(S, -(-C // 8) * 8))


def _dispatch_indices(ids: torch.Tensor, E: int, C: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """ids: [B, S, k] -> (idx [B, E, C] token of each (expert, slot),
    valid [B, E, C], slot [B, S, k] the slot each (token, choice) landed in,
    C if dropped), per row.  Choices are stably sorted by expert; the one of
    rank r in its expert's group takes slot r, and ranks >= C are dropped
    (the reference's ``.at[...].set(mode="drop")``): here they are written
    to one extra column that is sliced off."""
    B, S, k = ids.shape
    P = S * k
    dev = ids.device
    flat = ids.reshape(B, P)
    order = torch.sort(flat, dim=1, stable=True).indices
    sorted_e = torch.gather(flat, 1, order)
    counts = torch.zeros((B, E), dtype=torch.int64, device=dev
                         ).scatter_add_(1, flat, torch.ones_like(flat))
    starts = torch.cumsum(counts, 1) - counts
    rank = torch.arange(P, device=dev)[None, :] - torch.gather(starts, 1,
                                                               sorted_e)
    keep = rank < C
    dst = torch.where(keep, sorted_e * C + rank,
                      torch.full_like(rank, E * C))
    idx = torch.zeros((B, E * C + 1), dtype=torch.int64, device=dev
                      ).scatter_(1, dst, order // k)[:, :E * C]
    valid = torch.zeros((B, E * C + 1), dtype=torch.bool, device=dev
                        ).scatter_(1, dst, torch.ones_like(keep))[:, :E * C]
    slot = torch.empty_like(rank).scatter_(
        1, order, torch.where(keep, rank, torch.full_like(rank, C)))
    return (idx.reshape(B, E, C), valid.reshape(B, E, C),
            slot.reshape(B, S, k))


def _expert_ffn_stacked(p, xg: torch.Tensor, activation: str
                        ) -> torch.Tensor:
    """xg: [B, E, C, d] -> [B, E, C, d], each expert's rows through its
    FFN as batched einsums (the reference's ``_expert_ffn``)."""
    if activation == "swiglu":
        h = F.silu(torch.einsum("becd,edf->becf", xg, p.wg))
        h = h * torch.einsum("becd,edf->becf", xg, p.wu)
    else:
        h = F.gelu(torch.einsum("becd,edf->becf", xg, p.wu),
                   approximate="tanh")
    return torch.einsum("becf,efd->becd", h, p.wd)


def _per_row(fn, *ts):
    """``fn(*ts)``, for a ``fn`` whose every row (dim 0, the batch) depends
    on the same row of its inputs alone.  Of DTensors, each rank runs
    ``fn`` on its own rows: the inputs made whole but for their rows (as
    the first one's rows are split), the outputs laid out alike."""
    if not isinstance(ts[0], DTensor):
        return fn(*ts)
    mesh = ts[0].device_mesh
    rows = [pl if pl == Shard(0) else Replicate()
            for pl in ts[0].placements]
    B = ts[0].shape[0]
    out = fn(*(t.redistribute(mesh, rows).to_local() for t in ts))

    def wrap(t):
        shape = (B,) + tuple(t.shape[1:])
        return DTensor.from_local(
            t, mesh, rows, run_check=False, shape=torch.Size(shape),
            stride=tuple(math.prod(shape[i + 1:])
                         for i in range(len(shape))))
    return tuple(map(wrap, out)) if isinstance(out, tuple) else wrap(out)


def _gather_slots(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, S, d], idx [B, E, C] -> [B, E, C, d], each row's tokens."""
    rows = torch.arange(x.shape[0], device=x.device)
    return x[rows[:, None, None], idx]


def _combine(yg: torch.Tensor, valid: torch.Tensor, ids: torch.Tensor,
             slot: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Each (token, choice) reads its (expert, slot) of ``yg`` [B, E, C,
    d] (slot C, a dropped choice, reads 0), weighted by its gate weight:
    -> [B, S, d]."""
    B, E, C, d = yg.shape
    yg = yg * valid[..., None].to(yg.dtype)
    flat = F.pad(yg, (0, 0, 0, 1)).reshape(B, E * (C + 1), d)
    rows = torch.arange(B, device=yg.device)
    per_choice = flat[rows[:, None, None], ids * (C + 1) + slot]  # [B,S,k,d]
    return torch.sum(per_choice * weights[..., None], dim=2)


def moe_grouped(p, x: torch.Tensor, cfg: ModelConfig
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Train path.  x: [B, S, d] -> (y, aux).  Routing and capacity per
    batch row: each expert takes at most ``capacity(cfg, S)`` of the row's
    (token, choice) pairs, in token order; the rest are dropped (their
    term of the gate-weighted sum is 0).  On a mesh the routing, the
    gather and the combine run on each rank's own rows (``_per_row``),
    the expert products on DTensors."""
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    C = capacity(cfg, x.shape[1])
    weights, ids, _, aux = gate_topk(p.gate, x, k)
    idx, valid, slot = _per_row(lambda i: _dispatch_indices(i, E, C), ids)
    xg = _per_row(_gather_slots, x, idx)                      # [B,E,C,d]
    yg = _expert_ffn_stacked(p, xg, cfg.ffn_activation)
    y = _per_row(_combine, yg, valid, ids, slot, weights)
    if cfg.num_shared_experts:
        y = y + ffn_forward(p.shared, x, "swiglu")
    return y.to(x.dtype), aux


def moe_forward(p, x: torch.Tensor, cfg: ModelConfig, decode: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's rule: decode, or at most 4096 tokens of at most 8 per
    row, routes drop-free (``moe_global``); else ``moe_grouped``."""
    B, S, _ = x.shape
    if decode or (B * S <= 4096 and S <= 8):
        return moe_global(p, x, cfg)
    return moe_grouped(p, x, cfg)


def moe_ref(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Oracle: dense loop over every expert, no capacity drop."""
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    weights, ids, _, _ = gate_topk(p.gate, x, k)
    xf = x.reshape(-1, d)
    wf = weights.reshape(-1, k)
    idf = ids.reshape(-1, k)
    out = torch.zeros_like(xf)
    for e in range(E):
        ye = _expert_ffn(p, e, xf, cfg.ffn_activation)
        wsel = torch.sum(torch.where(idf == e, wf, torch.zeros_like(wf)),
                         dim=1)
        out = out + ye * wsel[:, None]
    y = out.reshape(B, S, d)
    if cfg.num_shared_experts:
        y = y + ffn_forward(p.shared, x, "swiglu")
    return y.to(x.dtype)

