"""Core layers: RMSNorm, RoPE, GQA attention (+ KV cache with sliding-window
ring), MLA attention (compressed latent cache, absorbed decode), FFN
variants.  The port of ``repro/models/layers.py``.

Functions take their weights as attributes of a module (``p.wq``) in the
reference's layouts (``wq [d, H, hd]``, ``wo [H, hd, d]``, ``wg [d, f]``) and
compute in the input's dtype; reductions (softmax, norms) run in f32, as the
reference does.  Attention is plain tensor ops, as the reference's ``mha`` is
plain jnp, except under ``attn_impl="kernel"``: there full-sequence attention
runs the flash-attention kernel and a one-token decode step over a plain
prefix the flash-decode kernel (``kernels/ops.py``).  MLA is plain tensor
ops under every ``attn_impl``, as in the reference: its q/k heads (nope +
rope) are wider than its v heads, and its decode attends in the latent
space, so neither attention kernel computes it.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------

def param(t: torch.Tensor) -> nn.Parameter:
    """A weight of the port's modules: inference only, no gradient."""
    return nn.Parameter(t, requires_grad=False)


def dense_init(gen: torch.Generator, shape, dtype: torch.dtype,
               device: torch.device, scale: float = 1.0) -> torch.Tensor:
    """N(0, (scale / sqrt(fan_in))²) drawn in f32 on ``device``, then cast
    (fan_in = shape[0], as the reference's ``_dense_init``)."""
    fan_in = shape[0] if len(shape) >= 2 else max(shape[0], 1)
    std = scale / math.sqrt(fan_in)
    t = torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                    device=device)
    return (t * std).to(dtype)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float
             ) -> torch.Tensor:
    """f32 normalisation, cast back to x's dtype BEFORE the weight multiply
    (reference ``layers.py:36``)."""
    dt = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(dt) * weight


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float,
               device: Optional[torch.device] = None) -> torch.Tensor:
    """Inverse frequencies, shape [head_dim // 2] (f32)."""
    ar = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (ar / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: [..., S, H, D]; positions: broadcastable to [..., S] (int)."""
    d = x.shape[-1]
    inv = rope_freqs(d, theta, x.device)                         # [D/2]
    ang = positions.to(torch.float32)[..., None] * inv           # [..., S, D/2]
    cos = torch.cos(ang)[..., None, :]                           # [..., S, 1, D/2]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# masked multi-head attention
# ---------------------------------------------------------------------------

def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        mask: Optional[torch.Tensor], softcap: Optional[float] = None
        ) -> torch.Tensor:
    """q: [B,Sq,H,D]  k: [B,Skv,Hkv,D]  v: [B,Skv,Hkv,Dv]  -> [B,Sq,H,Dv].

    GQA via head-group reshape; mask broadcastable to [B, 1|Hkv, 1|rep, Sq,
    Skv] (True = attend), masked scores set to -1e30.  Softmax in f32."""
    B, Sq, H, D = q.shape
    Hkv = k.shape[2]
    rep = H // Hkv
    qg = q.reshape(B, Sq, Hkv, rep, D)
    scores = torch.einsum("bqkrd,bskd->bkrqs", qg, k).float()
    scores = scores / math.sqrt(D)
    if softcap is not None:
        scores = torch.tanh(scores / softcap) * softcap
    if mask is not None:
        scores = torch.where(mask, scores,
                             torch.full((), -1e30, dtype=torch.float32,
                                        device=scores.device))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkrqs,bskd->bqkrd", probs, v)
    return out.reshape(B, Sq, H, v.shape[-1])


def causal_mask(sq: int, skv: int, window: Optional[int] = None,
                device: Optional[torch.device] = None) -> torch.Tensor:
    """[1,1,1,Sq,Skv] causal (optionally sliding-window) mask; query i sits
    at absolute position skv - sq + i."""
    qpos = torch.arange(sq, device=device)[:, None] + (skv - sq)
    kpos = torch.arange(skv, device=device)[None, :]
    m = kpos <= qpos
    if window is not None:
        m &= kpos > qpos - window
    return m[None, None, None]


# ---------------------------------------------------------------------------
# GQA attention block
# ---------------------------------------------------------------------------

def attention_forward(p, x: torch.Tensor, cfg: ModelConfig,
                      positions: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """Full-sequence attention (train / prefill), x: [B,S,D].

    ``attn_impl="kernel"`` without a logit softcap goes through the flash
    attention kernel with the reference's blocks, ``min(128, S)`` each (so
    S must be a multiple of 128 once it exceeds 128, as in the reference);
    anything else through ``mha``.  The port has no mask or cross-attention
    arguments here, the reference's other two conditions for the kernel."""
    B, S, _ = x.shape
    q = torch.einsum("bsd,dhk->bshk", x, p.wq)
    k = torch.einsum("bsd,dhk->bshk", x, p.wk)
    v = torch.einsum("bsd,dhk->bshk", x, p.wv)
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    if cfg.attn_impl == "kernel" and cfg.attn_logit_softcap is None:
        out = ops.flash_attention(q, k, v, causal=True,
                                  window=cfg.sliding_window,
                                  block_q=min(128, S), block_k=min(128, S))
    else:
        mask = causal_mask(S, S, cfg.sliding_window, x.device)
        out = mha(q, k, v, mask, cfg.attn_logit_softcap)
    return torch.einsum("bshk,hkd->bsd", out, p.wo)


# Rolling SWA caches get margin slots beyond the window so a speculative
# verification block (up to this many tokens) never clobbers slots that are
# still inside the window for the block's earlier queries.
SWA_RING_MARGIN = 16


def _positions(pos: int, pos_dev: Optional[torch.Tensor], Sq: int,
               device: torch.device) -> torch.Tensor:
    """The block's positions [Sq] int32, from ``pos_dev`` where given."""
    base = pos if pos_dev is None else pos_dev
    return base + torch.arange(Sq, dtype=torch.int32, device=device)


def init_kv_cache(cfg: ModelConfig, batch: int, max_seq: int,
                  dtype: torch.dtype, device: torch.device
                  ) -> Dict[str, torch.Tensor]:
    """KV cache ``{"k", "v": [B, S, Hkv, hd], "pos_map": [S] int32}``; a
    rolling buffer when sliding window is on.  ``pos_map[s]`` is the absolute
    position held by slot ``s`` (-1 = empty); masks are derived from it."""
    seq = (min(max_seq, cfg.sliding_window + SWA_RING_MARGIN)
           if cfg.sliding_window else max_seq)
    shp = (batch, seq, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shp, dtype=dtype, device=device),
            "v": torch.zeros(shp, dtype=dtype, device=device),
            "pos_map": torch.full((seq,), -1, dtype=torch.int32,
                                  device=device)}


def decode_kernel_route(cfg: ModelConfig, Sq: int, pos: int,
                        contiguous: bool) -> bool:
    """Whether ``attention_decode`` of a block of ``Sq`` tokens at ``pos``
    takes the flash-decode kernel (see its docstring): a host decision
    from Python values alone, which a captured step keys on."""
    return cfg.attn_impl == "kernel" and not cfg.use_mla and Sq == 1 \
        and contiguous and cfg.attn_logit_softcap is None \
        and (cfg.sliding_window is None or pos < cfg.sliding_window)


def attention_decode(p, x: torch.Tensor, cache: Dict[str, torch.Tensor],
                     pos: int, cfg: ModelConfig, contiguous: bool = False,
                     pos_dev: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Decode a block of Sq >= 1 tokens at absolute positions pos..pos+Sq-1
    (Sq > 1 = speculative-verification block).  x: [B,Sq,D]; pos: int.

    RoPE is applied at write time with the token's absolute position; for
    sliding-window configs the cache is a ring (slot = pos % W) and validity
    comes from the stored per-slot positions.  Unlike the reference, the
    cache is updated IN PLACE (and returned): a block's writes land on the
    slots of its own positions, so re-running a block (a fast-path fallback)
    or a later block overwrites them before any query can attend them.

    Route.  Under ``attn_impl="kernel"``, a one-token block (Sq == 1) with
    no logit softcap whose attendable slots are exactly [0, pos] goes
    through the flash-decode kernel (``ops.decode_attention``, lengths
    pos + 1).  That holds when the caller says every position before pos
    has been written (``contiguous``; a draft whose last token was accepted
    without being fed has a hole there, which the pos_map mask hides) and
    ``sliding_window`` is None or pos < ``sliding_window``: then no ring has
    wrapped (slot = position), each slot < pos holds its own position (each
    block writes its own slots), slots past pos hold only later positions,
    and the window excludes nothing, so the pos_map mask is the prefix mask.
    The route is decided from Python values alone (no host sync).  Every
    other block (verify blocks, a wrapped or windowed ring, a softcap,
    ``"xla"``, a hole) runs ``mha`` under the pos_map mask, as the
    reference does.

    ``pos_dev`` (a 0-d int32 tensor on x's device holding ``pos``), when
    given, is where every position that reaches the device comes from (the
    query positions, the ring slots, flash-decode's lengths), so a captured
    step replays at any position; the host int still picks the route."""
    B, Sq, _ = x.shape
    S = cache["k"].shape[1]
    q = torch.einsum("bsd,dhk->bshk", x, p.wq)
    k = torch.einsum("bsd,dhk->bshk", x, p.wk)
    v = torch.einsum("bsd,dhk->bshk", x, p.wv)
    qpos = _positions(pos, pos_dev, Sq, x.device)
    pp = qpos[None, :].expand(B, Sq)
    q = apply_rope(q, pp, cfg.rope_theta)
    k = apply_rope(k, pp, cfg.rope_theta)
    slots = torch.remainder(qpos, S).long() if cfg.sliding_window \
        else qpos.long()
    ck, cv, pos_map = cache["k"], cache["v"], cache["pos_map"]
    ck[:, slots] = k
    cv[:, slots] = v
    pos_map[slots] = qpos
    if decode_kernel_route(cfg, Sq, pos, contiguous):
        lengths = (qpos + 1).expand(B).contiguous()
        out = ops.decode_attention(q[:, 0], ck, cv, lengths)[:, None]
    else:
        # mask [1,1,1,Sq,S]: slot valid for query i iff it holds a position
        # <= qpos[i] (and within the window for SWA)
        valid = (pos_map[None, :] <= qpos[:, None]) & (pos_map[None, :] >= 0)
        if cfg.sliding_window:
            valid &= pos_map[None, :] > qpos[:, None] - cfg.sliding_window
        out = mha(q, ck, cv, valid[None, None, None], cfg.attn_logit_softcap)
    out = torch.einsum("bshk,hkd->bsd", out, p.wo)
    return out, cache


# ---------------------------------------------------------------------------
# MLA attention (deepseek-v2): compressed KV cache + absorbed decode
# ---------------------------------------------------------------------------

def mla_forward(p, x: torch.Tensor, cfg: ModelConfig,
                positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-sequence MLA (train / prefill), x: [B,S,D]: expand the latent
    into per-head keys and values and run ``mha`` under the causal mask
    (scale 1/sqrt(nope + rope)).  Weights: ``wq [d, H, nope + rope]``,
    ``wdkv [d, r]``, ``wkr [d, rope]``, ``wuk [r, H, nope]``,
    ``wuv [r, H, v]``, ``wo [H, v, d]``."""
    B, S, _ = x.shape
    nope, H = cfg.head_dim, cfg.num_heads
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    q = torch.einsum("bsd,dhk->bshk", x, p.wq)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    c_kv = torch.einsum("bsd,dr->bsr", x, p.wdkv)                # latent
    k_rope = apply_rope(torch.einsum("bsd,dk->bsk", x, p.wkr)[:, :, None, :],
                        positions, cfg.rope_theta)               # [B,S,1,rd]
    k_nope = torch.einsum("bsr,rhk->bshk", c_kv, p.wuk)
    v = torch.einsum("bsr,rhk->bshk", c_kv, p.wuv)
    k = torch.cat([k_nope, k_rope.expand(B, S, H, cfg.rope_head_dim)], -1)
    qf = torch.cat([q_nope, q_rope], -1)
    out = mha(qf, k, v, causal_mask(S, S, device=x.device))
    return torch.einsum("bshk,hkd->bsd", out, p.wo)


def init_mla_cache(cfg: ModelConfig, batch: int, max_seq: int,
                   dtype: torch.dtype, device: torch.device
                   ) -> Dict[str, torch.Tensor]:
    """MLA cache ``{"c_kv": [B, S, r], "k_rope": [B, S, rope], "pos_map":
    [S] int32}`` (-1 = empty slot); slot = position, no ring."""
    return {"c_kv": torch.zeros((batch, max_seq, cfg.kv_lora_rank),
                                dtype=dtype, device=device),
            "k_rope": torch.zeros((batch, max_seq, cfg.rope_head_dim),
                                  dtype=dtype, device=device),
            "pos_map": torch.full((max_seq,), -1, dtype=torch.int32,
                                  device=device)}


def mla_check_fits(pos: int, Sq: int, S: int):
    """An MLA decode block must lie inside the cache: the reference's
    ``dynamic_update_slice`` would clamp it onto earlier slots."""
    if pos < 0 or pos + Sq > S:
        raise ValueError(f"MLA decode block at positions [{pos}, {pos + Sq})"
                         f" does not fit a cache of {S} slots")


def mla_decode(p, x: torch.Tensor, cache: Dict[str, torch.Tensor], pos: int,
               cfg: ModelConfig, pos_dev: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Absorbed-matmul MLA decode of a block of Sq >= 1 tokens at positions
    pos..pos+Sq-1: W_uk is absorbed into the query and W_uv into the
    context, so attention runs in the latent space (scores ``q_lat c_kv^T +
    q_rope k_rope^T`` over sqrt(nope + rope), the full-sequence path's
    scale) and the cache stays compressed.  Validity comes from the cache's
    pos_map.

    The cache is updated IN PLACE (and returned), as ``attention_decode``
    does.  A block that runs past the cache's end raises: the reference's
    ``dynamic_update_slice`` would clamp it onto earlier slots.  With
    ``pos_dev`` every position on the device derives from it, as in
    ``attention_decode``; the check reads the host int."""
    B, Sq, _ = x.shape
    nope, rd = cfg.head_dim, cfg.rope_head_dim
    S = cache["c_kv"].shape[1]
    mla_check_fits(pos, Sq, S)
    qpos = _positions(pos, pos_dev, Sq, x.device)
    pp = qpos[None, :].expand(B, Sq)
    q = torch.einsum("bsd,dhk->bshk", x, p.wq)           # [B,Sq,H,nope+rd]
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = apply_rope(q_rope, pp, cfg.rope_theta)
    q_lat = torch.einsum("bshk,rhk->bshr", q_nope, p.wuk)   # absorb W_uk
    c_new = torch.einsum("bsd,dr->bsr", x, p.wdkv)
    kr_new = apply_rope(torch.einsum("bsd,dk->bsk", x, p.wkr)[:, :, None, :],
                        pp, cfg.rope_theta)[:, :, 0, :]
    c_kv, k_rope, pos_map = cache["c_kv"], cache["k_rope"], cache["pos_map"]
    slots = qpos.long()
    c_kv[:, slots] = c_new
    k_rope[:, slots] = kr_new
    pos_map[slots] = qpos
    scores = (torch.einsum("bshr,btr->bhst", q_lat, c_kv) +
              torch.einsum("bshk,btk->bhst", q_rope, k_rope)).float()
    scores = scores / math.sqrt(nope + rd)
    valid = (pos_map[None, :] <= qpos[:, None]) & (pos_map[None, :] >= 0)
    scores = torch.where(valid[None, None], scores,
                         torch.full((), -1e30, dtype=torch.float32,
                                    device=x.device))
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    ctx_lat = torch.einsum("bhst,btr->bshr", probs, c_kv)     # latent context
    ctx = torch.einsum("bshr,rhk->bshk", ctx_lat, p.wuv)      # absorb W_uv
    out = torch.einsum("bshk,hkd->bsd", ctx, p.wo)
    return out, cache


# ---------------------------------------------------------------------------
# FFN variants
# ---------------------------------------------------------------------------

def ffn_forward(p, x: torch.Tensor, activation: str) -> torch.Tensor:
    if activation == "swiglu":
        h = F.silu(torch.einsum("bsd,df->bsf", x, p.wg))
        h = h * torch.einsum("bsd,df->bsf", x, p.wu)
    elif activation == "relu2":
        h = torch.square(F.relu(torch.einsum("bsd,df->bsf", x, p.wu)))
    elif activation == "gelu":
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(torch.einsum("bsd,df->bsf", x, p.wu), approximate="tanh")
    else:
        raise ValueError(activation)
    return torch.einsum("bsf,fd->bsd", h, p.wd)
