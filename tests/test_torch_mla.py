"""PyTorch port, multi-head latent attention (deepseek-v2) against the JAX
reference: ``mla_forward`` (the expanded latent through ``mha``),
``mla_decode`` (the absorbed form) at Sq 1 and Sq 4 with the cache after
each step, the MLA prefill cache of a reduced deepseek ``DecoderLM``, and a
decode step over a ``pos_map`` hole.  Also: the port raises where a block
would run past the cache's end (the reference's ``dynamic_update_slice``
clamps it onto earlier slots), and MLA never takes an attention kernel,
under ``attn_impl="kernel"`` too.

Reduced deepseek-v2-lite-16b (H 4, nope 16 + rope 16, v 16, latent 32) in
f32, the reference's weights, inputs made from a seed with numpy.
Tolerance: atol 1e-5 on attention outputs and caches (f32 products summed
in another order), 1e-4 on model logits (three layers)."""
import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_config
from repro.models import layers as JL
from repro.models.registry import build_model as jax_build
from repro_torch.configs.registry import get_config
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.convert import load_jax_params
from repro_torch.models.registry import build_model

torch.set_num_threads(1)  # pytest -n: several processes share the cores

ATOL = 1e-5
LOGIT_ATOL = 1e-4
MAX_SEQ = 24


@pytest.fixture(scope="module")
def mla():
    jcfg = jax_config("deepseek-v2-lite-16b").reduced(dtype="float32")
    cfg = get_config("deepseek-v2-lite-16b").reduced(dtype="float32")
    jp = JL.init_mla(jax.random.PRNGKey(3), jcfg, jnp.float32)
    p = SimpleNamespace(**{n: torch.from_numpy(np.asarray(a).copy())
                           for n, a in jp.items()})
    return jcfg, cfg, jp, p


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=0)


def _x(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def test_mla_weights_have_the_reference_names_and_shapes(mla):
    jcfg, cfg, jp, _ = mla
    model = build_model(cfg, "cpu")
    attn = dict(model.layers[0].attn.named_parameters())
    assert {n: tuple(t.shape) for n, t in attn.items()} == \
        {n: tuple(a.shape) for n, a in jp.items()}
    assert set(attn) == {"wq", "wdkv", "wkr", "wuk", "wuv", "wo"}


@pytest.mark.parametrize("S", [1, 9])
def test_mla_forward_matches_jax(mla, S):
    jcfg, cfg, jp, p = mla
    x = _x(np.random.default_rng(S), 2, S, cfg.d_model)
    want = JL.mla_forward(jp, jnp.asarray(x), jcfg)
    got = L.mla_forward(p, torch.from_numpy(x), cfg)
    _close(got, want)


@pytest.mark.parametrize("sq", [1, 4])
def test_mla_decode_steps_and_caches_match_jax(mla, sq):
    """Three blocks of ``sq`` tokens from an empty cache: each block's
    output, and the whole cache (c_kv, k_rope, pos_map) after each step."""
    jcfg, cfg, jp, p = mla
    rng = np.random.default_rng(10 + sq)
    jc = JL.init_mla_cache(jcfg, 1, MAX_SEQ, jnp.float32)
    tc = L.init_mla_cache(cfg, 1, MAX_SEQ, torch.float32,
                          torch.device("cpu"))
    pos = 0
    for _ in range(3):
        x = _x(rng, 1, sq, cfg.d_model)
        want, jc = JL.mla_decode(jp, jnp.asarray(x), jc, pos, jcfg)
        got, tc = L.mla_decode(p, torch.from_numpy(x), tc, pos, cfg)
        _close(got, want)
        for name in ("c_kv", "k_rope", "pos_map"):
            _close(tc[name], jc[name])
        pos += sq


def test_mla_decode_over_a_pos_map_hole_matches_jax(mla):
    """A block that starts two positions past the last written one: the
    unwritten slots stay masked by pos_map on both sides."""
    jcfg, cfg, jp, p = mla
    rng = np.random.default_rng(20)
    jc = JL.init_mla_cache(jcfg, 1, MAX_SEQ, jnp.float32)
    tc = L.init_mla_cache(cfg, 1, MAX_SEQ, torch.float32,
                          torch.device("cpu"))
    for pos, sq in ((0, 5), (7, 1), (8, 3)):
        x = _x(rng, 1, sq, cfg.d_model)
        want, jc = JL.mla_decode(jp, jnp.asarray(x), jc, pos, jcfg)
        got, tc = L.mla_decode(p, torch.from_numpy(x), tc, pos, cfg)
        _close(got, want)
        _close(tc["pos_map"], jc["pos_map"])
    assert tc["pos_map"][5:7].tolist() == [-1, -1]


def test_mla_decode_raises_past_the_cache_end(mla):
    """The reference clamps such a block onto earlier slots
    (``dynamic_update_slice``); the port refuses it."""
    _, cfg, _, p = mla
    tc = L.init_mla_cache(cfg, 1, 8, torch.float32, torch.device("cpu"))
    x = torch.zeros((1, 3, cfg.d_model))
    L.mla_decode(p, x, tc, 5, cfg)                   # [5, 8): fits
    with pytest.raises(ValueError, match="does not fit"):
        L.mla_decode(p, x, tc, 6, cfg)


@pytest.fixture(scope="module")
def model():
    jcfg = jax_config("deepseek-v2-lite-16b").reduced(dtype="float32",
                                                      num_layers=3)
    cfg = get_config("deepseek-v2-lite-16b").reduced(dtype="float32",
                                                     num_layers=3)
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = load_jax_params(build_model(cfg, "cpu"),
                         jax.tree.map(np.asarray, jp))
    return jm, jp, tm


def test_mla_prefill_cache_matches_jax(model):
    """``prefill`` of a 10-token prompt: logits, and each layer's latent,
    roped key and pos_map, the leading dense layer's and the MoE layers'."""
    jm, jp, tm = model
    prompt = np.random.default_rng(30).integers(0, 256, (1, 10))
    jl, jc = jm.prefill(jp, jnp.asarray(prompt), MAX_SEQ)
    tl, tc = tm.prefill(torch.from_numpy(prompt), MAX_SEQ)
    _close(tl, jl, LOGIT_ATOL)
    assert len(tc["dense_layers"]) == 1 and len(tc["layers"]) == 2
    for stack in ("dense_layers", "layers"):
        for l, c in enumerate(tc[stack]):
            assert set(c) == {"c_kv", "k_rope", "pos_map"}
            for name in ("c_kv", "k_rope", "pos_map"):
                _close(c[name], jc[stack][name][l])
    assert tc["layers"][0]["pos_map"].tolist() == \
        list(range(10)) + [-1] * (MAX_SEQ - 10)


def test_mla_takes_no_attention_kernel(model, monkeypatch):
    """Under ``attn_impl="kernel"`` a deepseek model's prefill and decode
    steps (one token and a block) call neither flash attention nor
    flash-decode, and give the ``"xla"`` route's logits exactly."""
    _, _, tm = model
    calls = []
    for name in ("flash_attention", "decode_attention"):
        orig = getattr(ops, name)
        monkeypatch.setattr(ops, name,
                            lambda *a, _o=orig, _n=name, **k:
                            calls.append(_n) or _o(*a, **k))
    kcfg = dataclasses.replace(tm.cfg, attn_impl="kernel")
    km = build_model(kcfg, "cpu")
    km.load_state_dict(tm.state_dict())
    prompt = torch.from_numpy(np.random.default_rng(31).integers(
        0, 256, (1, 9)))
    outs = []
    for m in (tm, km):
        lg, c = m.prefill(prompt, MAX_SEQ)
        l1, c, _ = m.decode_step(c, prompt[:, :1], 9)
        l2, c, _ = m.decode_step(c, prompt[:, :4], 10)
        outs.append((lg, l1, l2))
    assert calls == []
    for a, b in zip(*outs):
        assert torch.equal(a, b)
