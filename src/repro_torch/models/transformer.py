"""Decoder-only LM for the dense, moe, ssm and hybrid families (the port of
``repro/models/transformer.py``).

The model is an ``nn.Module`` that owns its weights.  Parameter names follow
the reference's param-tree paths with the stacked layer axes unstacked:
``wte``, ``head``, ``ln_f``, ``layers.<l>.ln1``, ``layers.<l>.attn.wq``,
``layers.<l>.moe.gate``, ``layers.<l>.moe.wg``, ``layers.<l>.moe.shared.wg``,
``layers.<l>.ffn.wg``, ``dense_layers.<l>.ffn.wg``,
``layers.<l>.mamba.in_proj`` ... (``models/convert.py`` loads a reference
param tree into them).  With ``use_mla`` every block's ``attn`` is
multi-head latent attention (``wq, wdkv, wkr, wuk, wuv, wo``).

Layouts (the reference's ``_stacks``):

* dense / ssm: ``layers`` in order (every block ``mamba`` for ssm);
* moe: ``first_dense_layers`` dense-FFN blocks (``dense_layers.<l>``), then
  the MoE blocks (``layers.<l>``): ``layers[l]`` is always the l-th MoE
  layer, the one the offload runtime's host store and predictor index;
* hybrid (zamba2-style): G = num_layers // attn_every groups, each
  ``attn_every - 1`` mamba blocks (``mamba_groups.<g>.<i>``) and then the
  one ``shared_attn`` block, whose weights every group reuses with a KV
  cache of its own; then ``num_layers % attn_every`` mamba blocks
  (``tail.<t>``).

Three modes share one block function:

* ``forward``      full sequence, no cache -> (logits, aux)
* ``prefill``      full sequence, fills the KV caches
* ``decode_step``  a block of Sq >= 1 tokens against the caches; optionally
                   returns each layer's gate input (the SP-MoE predictor's
                   taps), per stack

Caches mirror the layout: per-block caches listed under ``dense_layers`` and
``layers``, or under ``mamba_groups`` [G][per], ``shared_attn`` [G] and
``tail`` for a hybrid.  An attention block's is ``{"k", "v", "pos_map"}``
(MLA: ``{"c_kv", "k_rope", "pos_map"}``), a mamba block's ``{"ssm",
"conv"}``.  They are updated in place.  The top-level dict also holds
``written``, a host int: positions [0, written) have all been written.  A
decode step that starts past it leaves positions no block wrote (a draft
whose last token was accepted without being fed), and from then on its
one-token steps take the masked attention route (``attention_decode``).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device, torch_dtype
from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.models import moe as MOE

Cache = Dict[str, Any]


class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device, gen):
        super().__init__()
        d, H, Hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, \
            cfg.head_dim
        self.wq = L.param(L.dense_init(gen, (d, H, hd), dtype, device))
        self.wk = L.param(L.dense_init(gen, (d, Hkv, hd), dtype, device))
        self.wv = L.param(L.dense_init(gen, (d, Hkv, hd), dtype, device))
        self.wo = L.param(L.dense_init(gen, (H, hd, d), dtype, device))


class MLA(nn.Module):
    """Multi-head latent attention (deepseek-v2, no q compression): ``wq
    [d, H, nope + rope]``, ``wdkv [d, r]``, ``wkr [d, rope]``, ``wuk [r, H,
    nope]``, ``wuv [r, H, v]``, ``wo [H, v, d]`` (the reference's
    ``init_mla``)."""

    def __init__(self, cfg: ModelConfig, dtype, device, gen):
        super().__init__()
        d, H = cfg.d_model, cfg.num_heads
        nope, rd, vd, r = cfg.head_dim, cfg.rope_head_dim, cfg.v_head_dim, \
            cfg.kv_lora_rank
        self.wq = L.param(L.dense_init(gen, (d, H, nope + rd), dtype, device))
        self.wdkv = L.param(L.dense_init(gen, (d, r), dtype, device))
        self.wkr = L.param(L.dense_init(gen, (d, rd), dtype, device))
        self.wuk = L.param(L.dense_init(gen, (r, H, nope), dtype, device))
        self.wuv = L.param(L.dense_init(gen, (r, H, vd), dtype, device))
        self.wo = L.param(L.dense_init(gen, (H, vd, d), dtype, device))


class FFN(nn.Module):
    def __init__(self, d: int, f: int, activation: str, dtype, device, gen):
        super().__init__()
        if activation == "swiglu":
            self.wg = L.param(L.dense_init(gen, (d, f), dtype, device))
        self.wu = L.param(L.dense_init(gen, (d, f), dtype, device))
        self.wd = L.param(L.dense_init(gen, (f, d), dtype, device))


class MoE(nn.Module):
    """Gate ``[d, E]`` (f32, on the compute device), the routed experts
    ``wg/wu [E, d, f]``, ``wd [E, f, d]`` and, with shared experts, one
    swiglu FFN ``shared`` of width ``num_shared_experts * f`` on the compute
    device.  The routed experts are drawn on the compute device one at a
    time, with the fan-in of one expert (the reference draws the stacked
    ``[E, ...]`` tensor, whose first axis it takes as the fan-in), and then
    moved to ``expert_device`` (the host, for a model whose experts the
    offload runtime serves from its cache)."""

    def __init__(self, cfg: ModelConfig, dtype, device, gen, expert_device):
        super().__init__()
        d, E, f = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
        self.gate = L.param(L.dense_init(gen, (d, E), torch.float32,
                                         device))
        names = ("wg", "wu", "wd") if cfg.ffn_activation == "swiglu" \
            else ("wu", "wd")
        for n in names:
            shape = (E, f, d) if n == "wd" else (E, d, f)
            w = torch.stack([L.dense_init(gen, shape[1:], dtype, device)
                             for _ in range(E)]).to(expert_device)
            setattr(self, n, L.param(w))
        if cfg.num_shared_experts:
            self.shared = FFN(d, cfg.num_shared_experts * f, "swiglu", dtype,
                              device, gen)


class Block(nn.Module):
    def __init__(self, kind: str, cfg: ModelConfig, dtype, device, gen,
                 expert_device):
        super().__init__()
        self.kind = kind
        self.ln1 = L.param(torch.ones(cfg.d_model, dtype=dtype,
                                      device=device))
        if kind == "mamba":
            self.mamba = M.Mamba(cfg, dtype, device, gen)
            return
        self.ln2 = L.param(torch.ones(cfg.d_model, dtype=dtype,
                                      device=device))
        self.attn = MLA(cfg, dtype, device, gen) if cfg.use_mla \
            else Attention(cfg, dtype, device, gen)
        if kind == "moe":
            self.moe = MoE(cfg, dtype, device, gen, expert_device)
        else:
            self.ffn = FFN(cfg.d_model, cfg.d_ff, cfg.ffn_activation, dtype,
                           device, gen)


class DecoderLM(nn.Module):
    """Families: dense, moe (leading dense-FFN layers, then MoE layers),
    ssm (every layer mamba) and hybrid (mamba groups around one shared
    attention block); GQA or MLA attention.

    ``device`` defaults to the card and raises without one (pass
    ``device="cpu"`` to run on the CPU).  Weights are drawn from
    ``generator`` (default: a generator on ``device`` seeded with ``seed``);
    ``expert_device`` (default ``device``) is where the routed experts
    live."""

    def __init__(self, cfg: ModelConfig, device: DeviceLike = None, *,
                 seed: int = 0, generator: Optional[torch.Generator] = None,
                 expert_device: DeviceLike = None):
        super().__init__()
        if cfg.family not in ("dense", "moe", "ssm", "hybrid"):
            raise NotImplementedError(
                f"{cfg.name}: only dense, moe, ssm and hybrid models are "
                f"ported yet")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = torch_dtype(cfg.dtype)
        expert_device = self.device if expert_device is None \
            else torch.device(expert_device)
        gen = generator if generator is not None else \
            torch.Generator(self.device).manual_seed(seed)
        dt, dev = self.dtype, self.device
        self.wte = L.param(L.dense_init(gen, (cfg.vocab_size, cfg.d_model),
                                       dt, dev, scale=cfg.d_model ** 0.5))
        self.ln_f = L.param(torch.ones(cfg.d_model, dtype=dt, device=dev))
        if not cfg.tie_embeddings:
            self.head = L.param(L.dense_init(gen, (cfg.d_model,
                                                  cfg.vocab_size), dt, dev))

        def blocks(kind: str, n: int) -> nn.ModuleList:
            return nn.ModuleList(Block(kind, cfg, dt, dev, gen, expert_device)
                                 for _ in range(n))

        if cfg.family == "hybrid":
            groups, per, tail = self.hybrid_layout()
            self.mamba_groups = nn.ModuleList(blocks("mamba", per)
                                              for _ in range(groups))
            self.shared_attn = Block("dense", cfg, dt, dev, gen,
                                     expert_device)
            self.tail = blocks("mamba", tail)
        elif cfg.is_moe:
            self.dense_layers = blocks("dense", cfg.first_dense_layers)
            self.layers = blocks("moe", cfg.num_moe_layers)
        else:
            kind = "mamba" if cfg.family == "ssm" else "dense"
            self.layers = blocks(kind, cfg.num_layers)

    def hybrid_layout(self) -> Tuple[int, int, int]:
        """(groups, mamba blocks per group, tail mamba blocks)."""
        cfg = self.cfg
        return (cfg.num_layers // cfg.attn_every, cfg.attn_every - 1,
                cfg.num_layers % cfg.attn_every)

    # -- pieces the offload runtime drives one at a time ---------------------
    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.wte[tokens]

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """Final norm + head.  x: [B, S, d] -> [B, S, V]."""
        xf = L.rms_norm(x, self.ln_f, self.cfg.norm_eps)
        if self.cfg.tie_embeddings:
            return torch.einsum("bsd,vd->bsv", xf, self.wte)
        return torch.einsum("bsd,dv->bsv", xf, self.head)

    def _attn_decode(self, blk: "Block", h: torch.Tensor, cache_l: Dict,
                     pos: int, contiguous: bool,
                     pos_dev: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.cfg.use_mla:
            return L.mla_decode(blk.attn, h, cache_l, pos, self.cfg,
                                pos_dev=pos_dev)[0]
        return L.attention_decode(blk.attn, h, cache_l, pos, self.cfg,
                                  contiguous=contiguous, pos_dev=pos_dev)[0]

    def attn_half(self, l: int, x: torch.Tensor, cache_l: Dict, pos: int,
                  pos_dev: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Decode-mode attention half of MoE layer ``l``: -> (x + attn, h2 =
        the FFN / gate input).  Writes the layer's KV cache in place.
        ``pos_dev``: ``pos`` as a 0-d int32 device tensor, the source of
        every position on the device (``attention_decode``)."""
        blk = self.layers[l]
        h = L.rms_norm(x, blk.ln1, self.cfg.norm_eps)
        # the offload runtime's target blocks cover every position in turn
        x = x + self._attn_decode(blk, h, cache_l, pos, True, pos_dev)
        return x, L.rms_norm(x, blk.ln2, self.cfg.norm_eps)

    def dense_stack(self, x: torch.Tensor, cache: Cache, pos: int,
                    pos_dev: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The leading dense-FFN layers in decode mode over ``cache``'s
        ``dense_layers`` (the offload runtime's target blocks, before its MoE
        layers; x unchanged without them)."""
        if not self.cfg.first_dense_layers:
            return x
        for blk, cl in zip(self.dense_layers, cache["dense_layers"]):
            x = self._block(blk, x, "decode", cl, pos, True, pos_dev)[0]
        return x

    def drop_experts(self):
        """Free the routed expert tensors (an offload runtime serves them
        from its own host store); the parameter names stay, and so do the
        dense FFNs and the shared experts."""
        for blk in self.layers:
            if blk.kind == "moe":
                for n in ("wg", "wu", "wd"):
                    if hasattr(blk.moe, n):
                        setattr(blk.moe, n, L.param(torch.empty(0)))

    # -- caches ---------------------------------------------------------------
    def init_cache(self, batch: int, max_seq: int) -> Cache:
        cfg, dt, dev = self.cfg, self.dtype, self.device

        def kv():
            if cfg.use_mla:
                return L.init_mla_cache(cfg, batch, max_seq, dt, dev)
            return L.init_kv_cache(cfg, batch, max_seq, dt, dev)

        def ssm(n: int):
            return [M.init_mamba_cache(cfg, batch, dt, dev)
                    for _ in range(n)]

        if cfg.family == "hybrid":
            groups, per, tail = self.hybrid_layout()
            return {"mamba_groups": [ssm(per) for _ in range(groups)],
                    "shared_attn": [kv() for _ in range(groups)],
                    "tail": ssm(tail), "written": 0}
        if cfg.family == "ssm":
            return {"layers": ssm(cfg.num_layers), "written": 0}
        if cfg.is_moe:
            return {"dense_layers": [kv() for _ in self.dense_layers],
                    "layers": [kv() for _ in self.layers], "written": 0}
        return {"layers": [kv() for _ in range(cfg.num_layers)],
                "written": 0}

    def _sites(self, cache: Optional[Cache]):
        """(stack name, block, its cache or None) in the order the model
        applies them."""
        if self.cfg.family != "hybrid":
            stacks = ("dense_layers", "layers") if self.cfg.is_moe \
                else ("layers",)
            for name in stacks:
                for l, blk in enumerate(getattr(self, name)):
                    yield name, blk, (cache[name][l] if cache is not None
                                      else None)
            return
        for g, group in enumerate(self.mamba_groups):
            for i, blk in enumerate(group):
                yield "mamba_groups", blk, (cache["mamba_groups"][g][i]
                                            if cache is not None else None)
            yield "shared_attn", self.shared_attn, (
                cache["shared_attn"][g] if cache is not None else None)
        for t, blk in enumerate(self.tail):
            yield "tail", blk, cache["tail"][t] if cache is not None else None

    # -- block ------------------------------------------------------------------
    def _block(self, blk: Block, x: torch.Tensor, mode: str,
               cache_l: Optional[Dict], pos: int, contiguous: bool = False,
               pos_dev: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """-> (x_out, aux_loss, gate_input_tap); a mamba block's tap is its
        output, as in the reference.  ``contiguous``: every position before
        ``pos`` is in the caches (``attention_decode``)."""
        cfg = self.cfg
        h = L.rms_norm(x, blk.ln1, cfg.norm_eps)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if blk.kind == "mamba":
            if mode == "decode":
                y, _ = M.mamba_decode(blk.mamba, h, cache_l, cfg)
            elif mode == "prefill":
                y, new = M.mamba_forward(blk.mamba, h, cfg, with_cache=True)
                cache_l.update(new)
            else:
                y = M.mamba_forward(blk.mamba, h, cfg)
            x = x + y
            return x, aux, x
        if mode == "decode":
            a = self._attn_decode(blk, h, cache_l, pos, contiguous, pos_dev)
        else:
            a = L.mla_forward(blk.attn, h, cfg) if cfg.use_mla \
                else L.attention_forward(blk.attn, h, cfg)
            if mode == "prefill":
                _attn_prefill_cache(blk.attn, h, cfg, cache_l)
        x = x + a
        h2 = L.rms_norm(x, blk.ln2, cfg.norm_eps)
        if blk.kind == "moe":
            y, aux = MOE.moe_global(blk.moe, h2, cfg)
        else:
            y = L.ffn_forward(blk.ffn, h2, cfg.ffn_activation)
        return x + y, aux, h2

    def _run(self, x: torch.Tensor, mode: str, cache: Optional[Cache],
             pos: int, collect_taps: bool = False, contiguous: bool = False,
             pos_dev: Optional[torch.Tensor] = None):
        """-> (x, aux, taps); taps are collected per stack, ``dense_layers``
        and ``layers`` (the reference collects none for hybrid models)."""
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        taps: Dict[str, List[torch.Tensor]] = {}
        for name, blk, cl in self._sites(cache):
            x, aux, tap = self._block(blk, x, mode, cl, pos, contiguous,
                                      pos_dev)
            aux_total = aux_total + aux
            if collect_taps:
                taps.setdefault(name, []).append(tap)
        if not collect_taps or self.cfg.family == "hybrid":
            return x, aux_total, {}
        return x, aux_total, {n: torch.stack(t) for n, t in taps.items()}

    # -- public API -----------------------------------------------------------
    def forward(self, tokens: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Full-sequence forward.  tokens: [B,S] -> (logits [B,S,V], aux).
        MoE layers route drop-free (the reference's train mode uses
        capacity routing for long sequences; that path waits)."""
        x, aux, _ = self._run(self.embed(tokens), "train", None, 0)
        return self.logits(x), aux

    def prefill(self, tokens: torch.Tensor, max_seq: int,
                cache: Optional[Cache] = None) -> Tuple[torch.Tensor, Cache]:
        """Fill caches with a prompt; return (last-position logits [B,V],
        cache).  ``cache``: one of this model's caches to fill in place
        (``reset_cache`` first, so it holds what a new one would), whose
        addresses a captured decode step keeps; else a new one."""
        if cache is None:
            cache = self.init_cache(tokens.shape[0], max_seq)
        else:
            reset_cache(cache)
        x, _, _ = self._run(self.embed(tokens), "prefill", cache, 0)
        cache["written"] = tokens.shape[1]
        return self.logits(x[:, -1:])[:, 0], cache

    def decode_route(self, cache: Cache, pos: int, Sq: int,
                     contiguous: Optional[bool] = None) -> Tuple[bool, bool]:
        """The host's part of a decode step of ``Sq`` tokens at ``pos``:
        (contiguous: every earlier position is in the cache, from its
        ``written`` unless the caller vouches for it; flash: the attention
        layers take the flash-decode kernel).  They decide which device
        work the step runs, so a captured step keys on them.  Raises where
        the step would (an MLA block past the cache's end)."""
        if self.cfg.use_mla:
            kv = (cache.get("dense_layers") or cache["layers"])[0]
            L.mla_check_fits(pos, Sq, kv["c_kv"].shape[1])
        if contiguous is None:
            contiguous = pos <= cache.get("written", 0)
        return contiguous, L.decode_kernel_route(self.cfg, Sq, pos,
                                                 contiguous)

    def decode_body(self, cache: Cache, tokens: torch.Tensor, pos: int,
                    contiguous: bool, collect_taps: bool = False,
                    pos_dev: Optional[torch.Tensor] = None):
        """The device work of ``decode_step``: -> (logits, taps); leaves
        ``written`` to ``note_written``."""
        x, _, taps = self._run(self.embed(tokens), "decode", cache, pos,
                               collect_taps, contiguous, pos_dev)
        return self.logits(x), taps

    @staticmethod
    def note_written(cache: Cache, pos: int, Sq: int, contiguous: bool):
        """A contiguous block extends the written prefix to pos + Sq."""
        if contiguous:
            cache["written"] = max(cache.get("written", 0), pos + Sq)

    def decode_step(self, cache: Cache, tokens: torch.Tensor, pos: int,
                    collect_taps: bool = False,
                    pos_dev: Optional[torch.Tensor] = None):
        """tokens: [B,Sq] at positions pos..pos+Sq-1 (Sq>1 = speculative
        verification block) -> (logits [B,Sq,V], cache, taps).  taps is
        ``{"layers": [L, B, Sq, d]}`` when collected (and ``"dense_layers"``
        for an MoE model with leading dense layers), else {}.  ``pos_dev``
        (``pos`` as a 0-d int32 device tensor): the device's positions
        come from it, bit for bit the same result."""
        contiguous, _ = self.decode_route(cache, pos, tokens.shape[1])
        logits, taps = self.decode_body(cache, tokens, pos, contiguous,
                                        collect_taps, pos_dev)
        self.note_written(cache, pos, tokens.shape[1], contiguous)
        return logits, cache, taps


def reset_cache(cache: Cache):
    """Return a cache to what ``init_cache`` made, in place: every tensor
    zero, every ``pos_map`` -1, nothing written."""
    def walk(node):
        if isinstance(node, dict):
            for name, t in node.items():
                if name == "pos_map":
                    t.fill_(-1)
                elif isinstance(t, torch.Tensor):
                    t.zero_()
                else:
                    walk(t)
        elif isinstance(node, list):
            for n in node:
                walk(n)
    walk(cache)
    cache["written"] = 0


def _attn_prefill_cache(p, h: torch.Tensor, cfg: ModelConfig, cache: Dict):
    """Recompute k/v (MLA: the latent and the roped key) for the prompt and
    write them into the cache (in place), ring-rolled so slot (pos % W)
    matches decode-side indexing."""
    B, S, _ = h.shape
    positions = torch.arange(S, device=h.device)[None, :]
    if cfg.use_mla:
        cache["c_kv"][:, :S] = torch.einsum("bsd,dr->bsr", h, p.wdkv)
        cache["k_rope"][:, :S] = L.apply_rope(
            torch.einsum("bsd,dk->bsk", h, p.wkr)[:, :, None, :], positions,
            cfg.rope_theta)[:, :, 0, :]
        cache["pos_map"][:S] = torch.arange(S, dtype=torch.int32,
                                            device=h.device)
        return
    k = L.apply_rope(torch.einsum("bsd,dhk->bshk", h, p.wk), positions,
                     cfg.rope_theta)
    v = torch.einsum("bsd,dhk->bshk", h, p.wv)
    W = cache["k"].shape[1]             # ring size (window + margin for SWA)
    n = cache["pos_map"].shape[0]
    if cfg.sliding_window and S > W:    # rolling buffer keeps the last W
        shift = S % W
        k = torch.roll(k[:, -W:], shift, dims=1)
        v = torch.roll(v[:, -W:], shift, dims=1)
        ar = torch.arange(W, device=h.device)
        pos_map = (S - W) + torch.remainder(ar - S, W)
        S = W
    else:
        ar = torch.arange(n, device=h.device)
        pos_map = torch.where(ar < S, ar, torch.full_like(ar, -1))
    cache["k"][:, :S] = k
    cache["v"][:, :S] = v
    cache["pos_map"].copy_(pos_map.to(torch.int32))
