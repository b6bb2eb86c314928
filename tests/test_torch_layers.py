"""PyTorch port, layers: RMSNorm, RoPE, masked attention (with softcap),
multi-token cache decode (incl. the sliding-window ring wrapping), the MoE
gate and the drop-free MoE against the JAX reference.

The same numpy inputs (made from a seed) go to both packages; f32, atol
1e-5 unless a test says otherwise."""
import dataclasses
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_config
from repro.models import layers as JL
from repro.models import moe as JM
from repro_torch.configs.registry import get_config
from repro_torch.models import layers as L
from repro_torch.models import moe as M

ATOL = 1e-5


def _cfgs(**over):
    """The same reduced mixtral on both sides."""
    j = jax_config("mixtral-8x7b").reduced(dtype="float32", **over)
    t = get_config("mixtral-8x7b").reduced(dtype="float32", **over)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    return j, t


def _close(got: torch.Tensor, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=0)


def test_rms_norm_and_rope():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 4, 16)).astype(np.float32)
    w = rng.standard_normal((16,)).astype(np.float32)
    _close(L.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5),
           JL.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5))
    pos = np.arange(3, 10)[None, :].repeat(2, 0)
    _close(L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e4),
           JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4))
    _close(L.rope_freqs(16, 1e4), JL.rope_freqs(16, 1e4))


@pytest.mark.parametrize("softcap", [None, 5.0])
@pytest.mark.parametrize("window", [None, 3])
def test_mha_matches_jax(softcap, window):
    rng = np.random.default_rng(1)
    q = rng.standard_normal((2, 6, 4, 8)).astype(np.float32)
    k = rng.standard_normal((2, 6, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, 6, 2, 8)).astype(np.float32)
    jmask = JL.causal_mask(6, 6, window)
    tmask = L.causal_mask(6, 6, window)
    assert np.array_equal(np.asarray(jmask), tmask.numpy())
    want = JL.mha(*map(jnp.asarray, (q, k, v)), jmask, softcap)
    got = L.mha(*map(torch.from_numpy, (q, k, v)), tmask, softcap)
    _close(got, want)


def _attn_params(cfg, seed):
    rng = np.random.default_rng(seed)
    d, H, Hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    shapes = {"wq": (d, H, hd), "wk": (d, Hkv, hd), "wv": (d, Hkv, hd),
              "wo": (H, hd, d)}
    p = {n: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
         for n, s in shapes.items()}
    return ({n: jnp.asarray(a) for n, a in p.items()},
            SimpleNamespace(**{n: torch.from_numpy(a) for n, a in p.items()}))


@pytest.mark.parametrize("window,max_seq,blocks", [
    (None, 32, [5, 1, 4, 3]),          # plain cache, multi-token blocks
    (16, 64, [5, 5, 5, 5, 5, 5, 4]),   # SWA ring of 32 slots wraps
])
def test_attention_decode_blocks_match_jax(window, max_seq, blocks):
    """A sequence of verify blocks through the KV cache: outputs and the
    cache state (k, v, pos_map) agree step by step, across the ring's wrap
    for sliding_window=16."""
    jcfg, tcfg = _cfgs(sliding_window=window)
    jp, tp = _attn_params(jcfg, 2)
    jc = JL.init_kv_cache(jcfg, 1, max_seq, jnp.float32)
    tc = L.init_kv_cache(tcfg, 1, max_seq, torch.float32,
                         torch.device("cpu"))
    rng = np.random.default_rng(3)
    pos = 0
    for n in blocks:
        x = rng.standard_normal((1, n, jcfg.d_model)).astype(np.float32)
        jo, jc = JL.attention_decode(jp, jnp.asarray(x), jc, pos, jcfg)
        to, tc = L.attention_decode(tp, torch.from_numpy(x), tc, pos, tcfg)
        _close(to, jo)
        for name in ("k", "v", "pos_map"):
            _close(tc[name], jc[name])
        pos += n
    if window:
        assert pos > tc["k"].shape[1]          # the ring really wrapped


def test_attention_forward_matches_jax():
    jcfg, tcfg = _cfgs()
    jp, tp = _attn_params(jcfg, 4)
    x = np.random.default_rng(5).standard_normal((2, 20, jcfg.d_model)
                                                 ).astype(np.float32)
    _close(L.attention_forward(tp, torch.from_numpy(x), tcfg),
           JL.attention_forward(jp, jnp.asarray(x), jcfg))


def _moe_params(cfg, seed):
    rng = np.random.default_rng(seed)
    d, E, f = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    p = {"gate": rng.standard_normal((d, E)) / np.sqrt(d),
         "wg": rng.standard_normal((E, d, f)) / np.sqrt(d),
         "wu": rng.standard_normal((E, d, f)) / np.sqrt(d),
         "wd": rng.standard_normal((E, f, d)) / np.sqrt(f)}
    p = {n: a.astype(np.float32) for n, a in p.items()}
    return ({n: jnp.asarray(a) for n, a in p.items()},
            SimpleNamespace(**{n: torch.from_numpy(a) for n, a in p.items()}))


def test_gate_topk_matches_jax():
    jcfg, tcfg = _cfgs()
    jp, tp = _moe_params(jcfg, 6)
    x = np.random.default_rng(7).standard_normal((9, jcfg.d_model)
                                                 ).astype(np.float32)
    jw, jids, jprobs, jaux = JM.gate_topk(jp["gate"], jnp.asarray(x), 2)
    tw, tids, tprobs, taux = M.gate_topk(tp.gate, torch.from_numpy(x), 2)
    assert np.array_equal(tids.numpy(), np.asarray(jids))
    _close(tw, jw)
    _close(tprobs, jprobs)
    _close(taux, jaux)


def test_moe_global_and_ref_match_jax():
    jcfg, tcfg = _cfgs()
    jp, tp = _moe_params(jcfg, 8)
    x = np.random.default_rng(9).standard_normal((1, 6, jcfg.d_model)
                                                 ).astype(np.float32)
    jy, jaux = JM.moe_global(jp, jnp.asarray(x), jcfg)
    ty, taux = M.moe_global(tp, torch.from_numpy(x), tcfg)
    _close(ty, jy)
    _close(taux, jaux)
    _close(M.moe_ref(tp, torch.from_numpy(x), tcfg),
           JM.moe_ref(jp, jnp.asarray(x), jcfg))


@pytest.mark.parametrize("activation", ["swiglu", "gelu", "relu2"])
def test_ffn_forward_matches_jax(activation):
    rng = np.random.default_rng(10)
    d, f = 16, 32
    p = {"wg": rng.standard_normal((d, f)), "wu": rng.standard_normal((d, f)),
         "wd": rng.standard_normal((f, d))}
    p = {n: (a / np.sqrt(a.shape[0])).astype(np.float32) for n, a in p.items()}
    x = rng.standard_normal((1, 5, d)).astype(np.float32)
    want = JL.ffn_forward({n: jnp.asarray(a) for n, a in p.items()},
                          jnp.asarray(x), activation)
    got = L.ffn_forward(SimpleNamespace(**{n: torch.from_numpy(a)
                                           for n, a in p.items()}),
                        torch.from_numpy(x), activation)
    _close(got, want)
