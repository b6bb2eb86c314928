"""PyTorch port, model: ``DecoderLM`` (reduced mixtral target and its dense
draft) against the JAX reference through the weight bridge
``params_from_jax``: prefill logits, multi-token decode blocks with their
gate-input taps and cache state, and the full-sequence forward; plus the
bridge's names and its bf16 route.

f32, atol 1e-4 on logits (four layers of f32 products summed in another
order), inputs made from a seed with numpy."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_config
from repro.core.engine import derive_draft_config as jax_derive
from repro.models.registry import build_model as jax_build
from repro_torch.configs.registry import get_config
from repro_torch.core.engine import derive_draft_config
from repro_torch.models.convert import load_jax_params, params_from_jax
from repro_torch.models.registry import build_model

ATOL = 1e-4


@pytest.fixture(scope="module", params=["target", "draft"])
def pair(request):
    jcfg = jax_config("mixtral-8x7b").reduced(dtype="float32")
    tcfg = get_config("mixtral-8x7b").reduced(dtype="float32")
    if request.param == "draft":
        jcfg, tcfg = jax_derive(jcfg), derive_draft_config(tcfg)
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0 if request.param == "target" else 1))
    tm = load_jax_params(build_model(tcfg, "cpu"),
                         jax.tree.map(np.asarray, jp))
    return jm, jp, tm


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=0)


def test_prefill_and_decode_blocks_match_jax(pair):
    jm, jp, tm = pair
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, 256, (1, 12))
    jl, jc = jm.prefill(jp, jnp.asarray(prompt), 48)
    tl, tc = tm.prefill(torch.from_numpy(prompt), 48)
    _close(tl, jl)
    pos = 12
    for n in (5, 1, 3):
        blk = rng.integers(0, 256, (1, n))
        jl, jc, jt = jm.decode_step(jp, jc, jnp.asarray(blk), pos,
                                    collect_taps=True)
        tl, tc, tt = tm.decode_step(tc, torch.from_numpy(blk), pos,
                                    collect_taps=True)
        _close(tl, jl)
        _close(tt["layers"], jt["layers"])
        for l in range(tm.cfg.num_layers):
            for name in ("k", "v", "pos_map"):
                _close(tc["layers"][l][name], jc["layers"][name][l])
        pos += n


def test_forward_matches_jax(pair):
    jm, jp, tm = pair
    tokens = np.random.default_rng(1).integers(0, 256, (2, 8))
    jl, jaux = jm.forward(jp, jnp.asarray(tokens))
    tl, taux = tm.forward(torch.from_numpy(tokens))
    _close(tl, jl)
    _close(taux, jaux, atol=1e-5)


def test_bridge_names_follow_the_jax_tree(pair):
    _, jp, tm = pair
    state = params_from_jax(jax.tree.map(np.asarray, jp))
    assert set(state) == set(tm.state_dict())
    assert "layers.0.attn.wq" in state and "wte" in state
    L = tm.cfg.num_layers
    assert f"layers.{L - 1}.ln2" in state and f"layers.{L}.ln2" not in state


def test_bridge_carries_bf16_through_a_uint16_view():
    jcfg = jax_config("mixtral-8x7b").reduced(dtype="bfloat16")
    tcfg = get_config("mixtral-8x7b").reduced(dtype="bfloat16")
    jp = jax_build(jcfg).init(jax.random.PRNGKey(0))
    tm = load_jax_params(build_model(tcfg, "cpu"),
                         jax.tree.map(np.asarray, jp))
    assert tm.layers[0].moe.wg.dtype == torch.bfloat16
    assert tm.layers[0].moe.gate.dtype == torch.float32
    want = np.asarray(jp["layers"]["moe"]["wg"][1].astype(jnp.float32))
    assert np.array_equal(tm.layers[1].moe.wg.float().numpy(), want)


def test_init_is_seeded_and_keeps_experts_where_asked():
    cfg = get_config("mixtral-8x7b").reduced(dtype="float32")
    a = build_model(cfg, "cpu", seed=3)
    b = build_model(cfg, "cpu", seed=3)
    c = build_model(cfg, "cpu", seed=4)
    assert torch.equal(a.layers[1].moe.wd, b.layers[1].moe.wd)
    assert not torch.equal(a.layers[1].moe.wd, c.layers[1].moe.wd)
    assert a.layers[0].moe.gate.dtype == torch.float32
    a.drop_experts()
    assert a.layers[0].moe.wg.numel() == 0
    assert a.layers[0].moe.gate.numel() > 0
