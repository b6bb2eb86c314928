"""Whisper-style encoder-decoder (the port of ``repro/models/encdec.py``).
The conv / audio frontend is a stub, as in the reference: the caller gives
precomputed frame embeddings ``[B, encoder_seq, d_model]``.  Decoder
blocks: causal self-attention (cached) + cross-attention over the encoder
output (its K/V computed once per decoder layer and cached at prefill) +
FFN.

Parameter names follow the reference's tree with its vmapped stacks
unstacked (``models/convert.py``): ``wte``, ``ln_enc``, ``ln_f``,
``enc.<l>.{ln1, attn.*, ln2, ffn.*}`` and ``dec.<l>.{ln1, self_attn.*,
ln_x, cross_attn.*, ln2, ffn.*}``.  The output head is ``wte`` (tied).

Attention routes as ``layers.attention_forward`` /
``layers.attention_decode`` decide: under ``attn_impl="kernel"`` the
decoder's causal self-attention runs flash attention over a full sequence
(``forward``, ``prefill``) and flash-decode in a one-token step over a
written prefix (``decode_step``); the encoder's bidirectional attention
(an all-true mask) and the cross-attention (``kv_override``) run ``mha``,
as the reference sends them to its plain ``mha``.  In train mode with
``cfg.remat`` each block of both stacks is checkpointed while autograd
records (the reference's ``jax.checkpoint`` around both scan bodies).

The serving cache is ``{"self": [per-layer KV cache {"k", "v",
"pos_map"}], "cross": {"k", "v": [L, B, encoder_seq, Hkv, hd]},
"written": host int}``; ``written`` is ``DecoderLM``'s: positions [0,
written) have all been written, so a one-token step at ``pos <=
written`` may take flash-decode.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device, torch_dtype
from repro_torch.models import layers as L
from repro_torch.models.transformer import (FFN, Attention,
                                            _attn_prefill_cache, _remat)

Cache = Dict[str, Any]


def _norm(cfg: ModelConfig, dtype, device) -> nn.Parameter:
    return L.param(torch.ones(cfg.d_model, dtype=dtype, device=device))


class EncBlock(nn.Module):
    """``{ln1, attn, ln2, ffn}`` (the reference's ``_init_enc_block``)."""

    def __init__(self, cfg: ModelConfig, dtype, device, gen):
        super().__init__()
        self.ln1 = _norm(cfg, dtype, device)
        self.attn = Attention(cfg, dtype, device, gen)
        self.ln2 = _norm(cfg, dtype, device)
        self.ffn = FFN(cfg.d_model, cfg.d_ff, cfg.ffn_activation, dtype,
                       device, gen)


class DecBlock(nn.Module):
    """``{ln1, self_attn, ln_x, cross_attn, ln2, ffn}`` (the reference's
    ``_init_dec_block``)."""

    def __init__(self, cfg: ModelConfig, dtype, device, gen):
        super().__init__()
        self.ln1 = _norm(cfg, dtype, device)
        self.self_attn = Attention(cfg, dtype, device, gen)
        self.ln_x = _norm(cfg, dtype, device)
        self.cross_attn = Attention(cfg, dtype, device, gen)
        self.ln2 = _norm(cfg, dtype, device)
        self.ffn = FFN(cfg.d_model, cfg.d_ff, cfg.ffn_activation, dtype,
                       device, gen)


class EncDecLM(nn.Module):
    """The encdec family (whisper-medium).  ``device`` defaults to the card
    and raises without one (pass ``device="cpu"`` to run on the CPU);
    weights are drawn from ``generator`` (default: a generator on
    ``device`` seeded with ``seed``), without gradients (a trainer turns
    them on)."""

    def __init__(self, cfg: ModelConfig, device: DeviceLike = None, *,
                 seed: int = 0, generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.family != "encdec":
            raise ValueError(f"{cfg.name}: EncDecLM is the encdec family's "
                             f"model, not {cfg.family!r}'s")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = torch_dtype(cfg.dtype)
        if self.device.type == "meta":   # shapes only: nothing is drawn
            gen = None
        else:
            gen = generator if generator is not None else \
                torch.Generator(self.device).manual_seed(seed)
        dt, dev = self.dtype, self.device
        self.wte = L.param(L.dense_init(gen, (cfg.vocab_size, cfg.d_model),
                                       dt, dev, scale=cfg.d_model ** 0.5))
        self.enc = nn.ModuleList(EncBlock(cfg, dt, dev, gen)
                                 for _ in range(cfg.encoder_layers))
        self.dec = nn.ModuleList(DecBlock(cfg, dt, dev, gen)
                                 for _ in range(cfg.num_layers))
        self.ln_enc = _norm(cfg, dt, dev)
        self.ln_f = _norm(cfg, dt, dev)

    def _remat_on(self) -> bool:
        return self.cfg.remat and torch.is_grad_enabled()

    # -- encoder ------------------------------------------------------------
    def _enc_block(self, blk: EncBlock, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        S = x.shape[1]
        full = torch.ones((1, 1, 1, S, S), dtype=torch.bool,
                          device=x.device)               # bidirectional
        h = L.rms_norm(x, blk.ln1, cfg.norm_eps)
        x = x + L.attention_forward(blk.attn, h, cfg, mask=full)
        h = L.rms_norm(x, blk.ln2, cfg.norm_eps)
        return x + L.ffn_forward(blk.ffn, h, cfg.ffn_activation)

    def encode(self, frames: torch.Tensor) -> torch.Tensor:
        """frames: [B, S_enc, d] (the stub frontend's output) -> encoder
        states [B, S_enc, d]: bidirectional attention with rope, then
        ``ln_enc``."""
        x = frames.to(self.dtype)
        remat = self._remat_on()
        for blk in self.enc:
            x = _remat(self._enc_block, self.cfg.remat_policy, blk, x) \
                if remat else self._enc_block(blk, x)
        return L.rms_norm(x, self.ln_enc, self.cfg.norm_eps)

    # -- decoder ------------------------------------------------------------
    def _cross_kv(self, enc: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Every decoder layer's cross-attention K / V over the encoder
        states, computed once: [L, B, S_enc, Hkv, hd] each."""
        k = torch.stack([torch.einsum("bsd,dhk->bshk", enc,
                                      blk.cross_attn.wk) for blk in self.dec])
        v = torch.stack([torch.einsum("bsd,dhk->bshk", enc,
                                      blk.cross_attn.wv) for blk in self.dec])
        return k, v

    def _dec_block(self, blk: DecBlock, x: torch.Tensor, ck: torch.Tensor,
                   cv: torch.Tensor, mode: str = "train",
                   cache_l: Optional[Dict] = None, pos: int = 0,
                   contiguous: bool = False) -> torch.Tensor:
        """One decoder block; ``mode`` "train" (no cache), "prefill" (also
        writes the self-attention cache) or "decode" (against it, in
        place)."""
        cfg = self.cfg
        h = L.rms_norm(x, blk.ln1, cfg.norm_eps)
        if mode == "decode":
            a, _ = L.attention_decode(blk.self_attn, h, cache_l, pos, cfg,
                                      contiguous=contiguous)
        else:
            a = L.attention_forward(blk.self_attn, h, cfg)
            if mode == "prefill":
                _attn_prefill_cache(blk.self_attn, h, cfg, cache_l)
        x = x + a
        h = L.rms_norm(x, blk.ln_x, cfg.norm_eps)
        x = x + L.attention_forward(blk.cross_attn, h, cfg,
                                    kv_override=(ck, cv), use_rope=False)
        h = L.rms_norm(x, blk.ln2, cfg.norm_eps)
        return x + L.ffn_forward(blk.ffn, h, cfg.ffn_activation)

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """Final norm + the tied head.  x: [B, S, d] -> [B, S, V]."""
        xf = L.rms_norm(x, self.ln_f, self.cfg.norm_eps)
        return torch.einsum("bsd,vd->bsv", xf, self.wte)

    # -- public API -----------------------------------------------------------
    def forward(self, tokens: torch.Tensor, frames: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Train-mode forward: tokens [B, S], frames [B, S_enc, d] ->
        (logits [B, S, V], aux = 0)."""
        k, v = self._cross_kv(self.encode(frames))
        x = self.wte[tokens]
        remat = self._remat_on()
        for l, blk in enumerate(self.dec):
            x = _remat(self._dec_block, self.cfg.remat_policy, blk, x, k[l],
                       v[l]) if remat else self._dec_block(blk, x, k[l], v[l])
        return self.logits(x), torch.zeros((), dtype=torch.float32,
                                           device=x.device)

    def init_cache(self, batch: int, max_seq: int) -> Cache:
        cfg, dt, dev = self.cfg, self.dtype, self.device
        cross = (cfg.num_layers, batch, cfg.encoder_seq, cfg.num_kv_heads,
                 cfg.head_dim)
        return {"self": [L.init_kv_cache(cfg, batch, max_seq, dt, dev)
                         for _ in range(cfg.num_layers)],
                "cross": {"k": torch.zeros(cross, dtype=dt, device=dev),
                          "v": torch.zeros(cross, dtype=dt, device=dev)},
                "written": 0}

    def prefill(self, tokens: torch.Tensor, max_seq: int,
                frames: torch.Tensor) -> Tuple[torch.Tensor, Cache]:
        """Encode ``frames``, cache every decoder layer's cross K / V and
        the prompt's self-attention K / V -> (last-position logits [B, V],
        cache)."""
        k, v = self._cross_kv(self.encode(frames))
        cache = self.init_cache(tokens.shape[0], max_seq)
        cache["cross"]["k"].copy_(k)
        cache["cross"]["v"].copy_(v)
        x = self.wte[tokens]
        for l, blk in enumerate(self.dec):
            x = self._dec_block(blk, x, k[l], v[l], "prefill",
                                cache["self"][l])
        cache["written"] = tokens.shape[1]
        return self.logits(x[:, -1:])[:, 0], cache

    def decode_step(self, cache: Cache, tokens: torch.Tensor, pos: int):
        """tokens [B, Sq] at positions pos..pos+Sq-1 against the cache
        (updated in place) -> (logits [B, Sq, V], cache, {}: an encdec
        model has no taps).  The step is contiguous when ``pos <=
        cache["written"]`` (``DecoderLM``'s rule): then a one-token step
        takes flash-decode under ``attn_impl="kernel"``; any other block the
        masked ``mha``.  The cross-attention runs ``mha`` over the cached
        encoder K / V with no mask."""
        Sq = tokens.shape[1]
        contiguous = pos <= cache.get("written", 0)
        ck, cv = cache["cross"]["k"], cache["cross"]["v"]
        x = self.wte[tokens]
        for l, blk in enumerate(self.dec):
            x = self._dec_block(blk, x, ck[l], cv[l], "decode",
                                cache["self"][l], pos, contiguous)
        if contiguous:
            cache["written"] = max(cache.get("written", 0), pos + Sq)
        return self.logits(x), cache, {}
