"""MoE FFN block: top-k gating and the drop-free decode routing.  The port of
``repro/models/moe.py`` (``moe_grouped``, the training path, waits).

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
    """Decode path: drop-free sorted routing, one product per routed expert.
    x: [B, S, d] -> (y, aux).  The combine runs in the expert dtype, as the
    reference's does (its engine's cache_moe combines in f32).  Reads the
    group sizes on the host: this resident-weights path is not the offload
    runtime's hot path."""
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    T = B * S
    xf = x.reshape(T, d)
    weights, ids, _, aux = gate_topk(p.gate, xf, k)
    flat = ids.reshape(-1)
    order = torch.sort(flat, stable=True).indices
    tok = order // k
    xs = xf[tok]
    sizes = torch.bincount(flat, minlength=E).tolist()
    ys = torch.zeros((T * k, d), dtype=x.dtype, device=x.device)
    lo = 0
    for e in range(E):
        hi = lo + sizes[e]
        if hi > lo:
            ys[lo:hi] = _expert_ffn(p, e, xs[lo:hi], cfg.ffn_activation)
        lo = hi
    y = torch.zeros((T, d), dtype=ys.dtype, device=x.device).index_add_(
        0, tok, ys * weights.reshape(-1)[order][:, None])
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

