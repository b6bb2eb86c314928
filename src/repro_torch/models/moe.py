"""MoE FFN block: top-k gating and the drop-free decode routing.  The port of
``repro/models/moe.py`` (``moe_grouped``, the training path, waits).
``moe_global`` runs the routed experts through the expert-FFN kernel, so an
MoE draft's steps and a resident MoE target's steps make no host sync.

Expert weights are ``[E, d, f]`` / ``[E, f, d]``; the gate is ``[d, E]`` in
f32.  Shared experts (deepseek) are one swiglu FFN ``p.shared`` of width
``num_shared_experts * moe_d_ff`` that every token runs, added to the routed
sum.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

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
    flat_ids = ids.reshape(-1)
    counts = torch.zeros(E, dtype=torch.float32, device=x.device
                         ).index_add_(0, flat_ids,
                                      torch.ones_like(flat_ids,
                                                      dtype=torch.float32))
    frac = counts / torch.clamp(torch.sum(counts), min=1.0)
    mean_prob = torch.mean(probs.reshape(-1, E), dim=0)
    aux = E * torch.sum(frac * mean_prob)
    return weights.to(x.dtype), ids, probs, aux


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
    stacks, expert id = slot id.  x: [B, S, d] -> (y, aux).

    Nothing here reads the device from the host: the grouping is
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
    h = K.gate_up(xf, g, p.wg, p.wu) if cfg.ffn_activation == "swiglu" \
        else K.up_gelu(xf, g, p.wu)
    ys = K.down(h, g, p.wd)                    # [T·k, d], rows by expert
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

