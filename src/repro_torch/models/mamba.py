"""Mamba2 (SSD) block: in_proj -> causal conv -> SSD -> gated RMSNorm ->
out_proj.  The port of ``repro/models/mamba.py``.

Single B/C group.  The full-sequence path (train and prefill) takes y, and
in prefill also the final SSM state, from ONE call of ``ops.ssd``: the
chunked-scan kernel on the card, ``ref.ssd_ref`` on the CPU.  The reference
runs ``ssd_ref`` twice in prefill (here and in
``transformer._mamba_prefill_cache``); both give the same state.  Decode is
the O(1) recurrent update with a rolling conv window, plain torch as in the
reference (``ref.ssd_decode_ref``), one token at a time; it is written with
matrix products and broadcasts rather than ``einsum``, which launches
several kernels per call (the step is bound by the host's launches).

Parameters live on a :class:`Mamba` module under the reference's names and
layouts (``in_proj [d, 2·d_inner + 2·N + H]``, ``conv_w [W, conv_ch]``,
``A_log``/``D``/``dt_bias [H]`` f32, ``norm [d_inner]``, ``out_proj
[d_inner, d]``); the functions take the module.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.kernels import ref as R
from repro_torch.models import layers as L

Cache = Dict[str, torch.Tensor]


def dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    """(d_inner, heads, state width N, conv channels = d_inner + 2N)."""
    d_in = cfg.d_inner
    return d_in, d_in // cfg.ssm_head_dim, cfg.ssm_state_dim, \
        d_in + 2 * cfg.ssm_state_dim


class Mamba(nn.Module):
    """One block's parameters, drawn as the reference's ``init_mamba``
    draws them: normal projections, conv taps with fan-in W, dt log-uniform
    in [1e-3, 1e-1] stored as its inverse softplus, A_log = log(1..H)."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype,
                 device: torch.device, gen: torch.Generator):
        super().__init__()
        d = cfg.d_model
        d_in, H, N, conv_ch = dims(cfg)
        f32 = torch.float32
        self.in_proj = L.param(L.dense_init(gen, (d, 2 * d_in + 2 * N + H),
                                            dtype, device))
        self.conv_w = L.param(L.dense_init(gen, (cfg.ssm_conv_width,
                                                 conv_ch), dtype, device))
        self.conv_b = L.param(torch.zeros(conv_ch, dtype=dtype,
                                          device=device))
        u = torch.rand((H,), generator=gen, dtype=f32, device=device)
        dt = torch.exp(u * (math.log(0.1) - math.log(0.001))
                       + math.log(0.001))
        self.A_log = L.param(torch.log(torch.arange(1, H + 1, dtype=f32,
                                                    device=device)))
        self.D = L.param(torch.ones(H, dtype=f32, device=device))
        self.dt_bias = L.param(dt + torch.log(-torch.expm1(-dt)))
        self.norm = L.param(torch.ones(d_in, dtype=dtype, device=device))
        self.out_proj = L.param(L.dense_init(gen, (d_in, d), dtype, device))


def _split(zxbcdt: torch.Tensor, cfg: ModelConfig):
    """-> (z, x, B, C, dt) along the last axis."""
    d_in, H, N, _ = dims(cfg)
    return torch.split(zxbcdt, [d_in, d_in, N, N, H], dim=-1)


def _causal_conv(xBC: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    """Depthwise causal conv + SiLU, in xBC's dtype.  xBC: [B,S,ch];
    w: [W,ch]."""
    W, S = w.shape[0], xBC.shape[1]
    pad = F.pad(xBC, (0, 0, W - 1, 0))
    out = sum(pad[:, i:i + S, :] * w[i] for i in range(W))
    return F.silu(out + b)


def mamba_forward(p: Mamba, x: torch.Tensor, cfg: ModelConfig,
                  with_cache: bool = False
                  ) -> Union[torch.Tensor, Tuple[torch.Tensor, Cache]]:
    """x: [B,S,d] -> [B,S,d] (full-sequence SSD).  With ``with_cache`` also
    the decode cache after the sequence: ``{"ssm": final state [B,H,P,N]
    f32, "conv": the last W-1 pre-conv rows [B,W-1,conv_ch]}``, from the
    same ``ops.ssd`` call.

    The chunk is ``min(ssm_chunk, S)``; a longer S that it does not divide
    is padded at the end with dt = 0, which leaves the state unchanged."""
    Bsz, S, _ = x.shape
    d_in, H, N, _ = dims(cfg)
    P = cfg.ssm_head_dim
    z, xs, Bm, Cm, dt = _split(torch.einsum("bsd,dp->bsp", x, p.in_proj),
                               cfg)
    xBC_pre = torch.cat([xs, Bm, Cm], dim=-1)
    xs, Bm, Cm = torch.split(_causal_conv(xBC_pre, p.conv_w, p.conv_b),
                             [d_in, N, N], dim=-1)
    xh = xs.reshape(Bsz, S, H, P)
    dt = F.softplus(dt.float() + p.dt_bias)
    A = -torch.exp(p.A_log)
    chunk = min(cfg.ssm_chunk, S)
    pad = (-S) % chunk
    ins = [xh, dt, Bm, Cm]
    if pad:
        ins = [F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad)) for t in ins]
    xp, dtp, Bp, Cp = (t.contiguous() for t in ins)
    y, state = ops.ssd(xp, dtp, A, Bp, Cp, chunk)
    y = y[:, :S] + xh * p.D[:, None]
    y = y.reshape(Bsz, S, d_in).to(x.dtype)
    y = L.rms_norm(y * F.silu(z), p.norm, cfg.norm_eps)
    out = torch.einsum("bsp,pd->bsd", y, p.out_proj)
    if not with_cache:
        return out
    W = cfg.ssm_conv_width
    conv = F.pad(xBC_pre, (0, 0, W - 1, 0))[:, -(W - 1):, :]
    return out, {"ssm": state, "conv": conv.contiguous()}


def init_mamba_cache(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                     device: torch.device) -> Cache:
    d_in, H, N, conv_ch = dims(cfg)
    return {"ssm": torch.zeros((batch, H, cfg.ssm_head_dim, N),
                               dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cfg.ssm_conv_width - 1, conv_ch),
                                dtype=dtype, device=device)}


def mamba_decode(p: Mamba, x: torch.Tensor, cache: Cache, cfg: ModelConfig
                 ) -> Tuple[torch.Tensor, Cache]:
    """One-token recurrent step.  x: [B,1,d] -> ([B,1,d], cache), the cache
    updated in place.  A block of several tokens raises: the reference
    reads only its first token and broadcasts that output over the block,
    which is why speculative decoding over an SSM target is refused."""
    if x.shape[1] != 1:
        raise ValueError(f"mamba decode takes one token per step, got "
                         f"{x.shape[1]}")
    Bsz = x.shape[0]
    d_in, H, N, _ = dims(cfg)
    f32 = torch.float32
    z, xs, Bm, Cm, dt = _split(x[:, 0] @ p.in_proj, cfg)
    window = torch.cat([cache["conv"], torch.cat([xs, Bm, Cm], -1)[:, None]],
                       dim=1)                                 # [B, W, ch]
    conv = (window.to(f32) * p.conv_w.to(f32)).sum(dim=1)
    xBC = F.silu(conv + p.conv_b.to(f32)).to(x.dtype)
    xs, Bm, Cm = torch.split(xBC, [d_in, N, N], dim=-1)
    xh = xs.reshape(Bsz, H, cfg.ssm_head_dim)
    dt = F.softplus(dt.to(f32) + p.dt_bias)
    y, state = R.ssd_decode_ref(cache["ssm"], xh, dt, -torch.exp(p.A_log),
                                Bm, Cm)
    y = (y + xh * p.D[:, None]).reshape(Bsz, d_in).to(x.dtype)
    y = L.rms_norm(y * F.silu(z), p.norm, cfg.norm_eps)
    cache["ssm"].copy_(state)
    cache["conv"].copy_(window[:, 1:])
    return (y @ p.out_proj)[:, None, :], cache
