"""PyTorch port, the MoE train route (``moe_grouped``, ``moe_forward``)
against the JAX reference.

* ``moe_grouped`` under ``capacity_factor=0.5`` and a gate skewed toward
  expert 0, so that choices are dropped: ``y`` and ``aux`` against the
  reference's ``moe_grouped``, and the gradients of ``sum(y·r)`` with
  respect to x, the gate and every expert stack (and a shared expert's)
  against ``jax.grad``; for mixtral, deepseek (a shared expert), phi and a
  gelu-expert mixtral;
* at ``capacity_factor=8`` (nothing dropped) against the reference's
  ``moe_ref``, as ``tests/test_moe.py`` holds the reference's own routes;
* ``_dispatch_indices`` against the reference's, ``capacity`` against its
  rule, and ``moe_forward``'s choice of route;
* ``moe_global`` under autograd (a train-mode call with S <= 8) computes
  its products with torch ops: its values and gradients against the
  reference's ``moe_global`` under ``jax.grad``;
* the repair of the train-mode forward: reduced mixtral, f32, B 2 x S 32,
  capacity 0.5: the port's ``forward`` logits against the reference's.
  Before the port routed train mode through ``moe_grouped``, these
  differed by up to 4.9.

Reduced configs in f32, the reference's weights, inputs made from a seed
with numpy.  Tolerance: 1e-5 on y and aux, 1e-4 relative (to the largest
magnitude of each gradient) on gradients, 1e-4 on logits."""
import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_config
from repro.models import moe as JMOE
from repro.models.registry import build_model as jax_build
from repro_torch.configs.registry import get_config
from repro_torch.models import moe as MOE
from repro_torch.models.convert import load_jax_params
from repro_torch.models.registry import build_model

torch.set_num_threads(1)  # pytest -n: several processes share the cores

ATOL = 1e-5
GRAD_RTOL = 1e-4
CASES = {"mixtral": ("mixtral-8x7b", {}),
         "deepseek": ("deepseek-v2-lite-16b", {}),
         "phi": ("phi-3.5-moe", {}),
         "gelu": ("mixtral-8x7b", {"ffn_activation": "gelu"})}


def _cfgs(case, **over):
    arch, extra = CASES[case]
    jcfg = dataclasses.replace(jax_config(arch).reduced(dtype="float32"),
                               **extra, **over)
    cfg = dataclasses.replace(get_config(arch).reduced(dtype="float32"),
                              **extra, **over)
    return jcfg, cfg


def _layer(jcfg, skew: bool, seed: int = 0):
    """The reference's MoE layer (numpy leaves), its gate skewed toward
    expert 0 when asked; a gelu layer drops the ``wg`` it never reads."""
    jp = jax.tree.map(np.asarray, JMOE.init_moe(jax.random.PRNGKey(seed),
                                                jcfg, jnp.float32))
    if skew:
        jp["gate"] = jp["gate"].copy()
        jp["gate"][:, 0] += 0.3
    if jcfg.ffn_activation != "swiglu":
        jp.pop("wg")
    return jp


def _port(jp):
    """The same layer as the port's modules see it, every tensor a leaf
    that requires grad."""
    def t(a):
        return torch.from_numpy(a.copy()).requires_grad_(True)
    p = {n: t(a) for n, a in jp.items() if n != "shared"}
    if "shared" in jp:
        p["shared"] = SimpleNamespace(**{n: t(a)
                                         for n, a in jp["shared"].items()})
    return SimpleNamespace(**p)


def _leaves(p):
    out = {n: v for n, v in vars(p).items() if n != "shared"}
    if hasattr(p, "shared"):
        out.update({f"shared.{n}": v for n, v in vars(p.shared).items()})
    return out


def _jleaves(g):
    out = {n: v for n, v in g.items() if n != "shared"}
    out.update({f"shared.{n}": v for n, v in g.get("shared", {}).items()})
    return out


def _inputs(cfg, B, S, seed=1):
    rng = np.random.default_rng(seed)
    x = (0.25 * rng.standard_normal((B, S, cfg.d_model)) + 0.1
         ).astype(np.float32)
    r = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    return x, r


def _grad_close(got, want):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got.detach().numpy(), want,
                               atol=GRAD_RTOL * scale, rtol=0)


def _check_values_and_grads(jfn, tfn, jcfg, cfg, B, S):
    jp = _layer(jcfg, skew=True)
    p = _port(jp)
    x, r = _inputs(cfg, B, S)
    jx = jnp.asarray(x)

    def jloss(params, xx):
        y, aux = jfn(params, xx, jcfg)
        return jnp.sum(y * r), (y, aux)

    (_, (jy, jaux)), (jg, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(
            jax.tree.map(jnp.asarray, jp), jx)
    tx = torch.from_numpy(x).requires_grad_(True)
    y, aux = tfn(p, tx, cfg)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                               atol=ATOL, rtol=0)
    assert abs(float(aux.detach()) - float(jaux)) <= ATOL
    torch.sum(y * torch.from_numpy(r)).backward()
    _grad_close(tx.grad, jgx)
    jl = _jleaves(jg)
    got = _leaves(p)
    assert set(got) == set(jl)
    for name, t in got.items():
        _grad_close(t.grad, jl[name])


@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_grouped_drops_as_the_reference_and_matches_its_grads(case):
    jcfg, cfg = _cfgs(case, capacity_factor=0.5)
    B, S = 2, 32
    x, _ = _inputs(cfg, B, S)
    # the skew overflows expert 0's capacity in every row
    _, ids, _, _ = MOE.gate_topk(_port(_layer(jcfg, skew=True)).gate.detach(),
                                 torch.from_numpy(x), cfg.num_experts_per_tok)
    per_row = (ids == 0).sum(dim=(1, 2))
    assert (per_row > MOE.capacity(cfg, S)).all()
    _check_values_and_grads(JMOE.moe_grouped, MOE.moe_grouped, jcfg, cfg,
                            B, S)


@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_grouped_without_drops_matches_moe_ref(case):
    jcfg, cfg = _cfgs(case, capacity_factor=8.0)
    jp = _layer(jcfg, skew=False)
    x, _ = _inputs(cfg, 2, 16)
    want = JMOE.moe_ref(jax.tree.map(jnp.asarray, jp), jnp.asarray(x), jcfg)
    with torch.no_grad():
        got, _ = MOE.moe_grouped(_port(jp), torch.from_numpy(x), cfg)
        ref = MOE.moe_ref(_port(jp), torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(ref.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("E,k,S", [(8, 2, 32), (4, 1, 9), (16, 4, 8)])
def test_dispatch_indices_match_the_reference(E, k, S):
    rng = np.random.default_rng(E * 100 + S)
    ids = np.stack([np.stack([rng.permutation(E)[:k] for _ in range(S)])
                    for _ in range(3)])
    ids[0, :, 0] = 0                       # one row overflows expert 0
    C = 8
    idx, valid, slot = MOE._dispatch_indices(torch.from_numpy(ids), E, C)
    for b in range(3):
        widx, wvalid, wslot = JMOE._dispatch_indices(jnp.asarray(ids[b]),
                                                     E, C)
        np.testing.assert_array_equal(valid[b].numpy(), np.asarray(wvalid))
        np.testing.assert_array_equal(slot[b].numpy(), np.asarray(wslot))
        # an empty slot's token is 0 on both sides
        np.testing.assert_array_equal(idx[b].numpy(), np.asarray(widx))


def test_capacity_and_route_follow_the_reference_rule(monkeypatch):
    _, cfg = _cfgs("mixtral")
    for S in (1, 8, 9, 32, 100, 1024):
        want = int(np.ceil(cfg.capacity_factor * S * 2 / 8))
        want = max(8, min(S, -(-want // 8) * 8))
        assert MOE.capacity(cfg, S) == want
    assert MOE.capacity(get_config("mixtral-8x7b"), 1024) == 320
    seen = []
    monkeypatch.setattr(MOE, "moe_global",
                        lambda p, x, c: seen.append("global") or (x, 0))
    monkeypatch.setattr(MOE, "moe_grouped",
                        lambda p, x, c: seen.append("grouped") or (x, 0))
    for B, S, decode in ((1, 8, False), (2, 9, False), (2, 9, True),
                         (513, 8, False), (512, 8, False)):
        MOE.moe_forward(None, torch.zeros(B, S, 1), cfg, decode=decode)
    assert seen == ["global", "grouped", "global", "grouped", "global"]


@pytest.mark.parametrize("case", ["mixtral", "deepseek"])
def test_moe_global_under_autograd_matches_the_reference_and_its_grads(case):
    """S <= 8 in train mode: drop-free routing whose products are torch ops
    (the kernel wrappers refuse autograd)."""
    jcfg, cfg = _cfgs(case)
    _check_values_and_grads(JMOE.moe_global, MOE.moe_global, jcfg, cfg, 3, 5)


def test_train_mode_forward_matches_the_reference_under_capacity_drops():
    """Repair: the port's train-mode forward routed MoE layers drop-free in
    every mode, and its logits differed from the reference's by up to 4.9
    here; it now routes as ``block_apply`` does (``moe_forward(...,
    decode=(mode != "train"))``)."""
    jcfg = dataclasses.replace(
        jax_config("mixtral-8x7b").reduced(dtype="float32"),
        capacity_factor=0.5)
    cfg = dataclasses.replace(
        get_config("mixtral-8x7b").reduced(dtype="float32"),
        capacity_factor=0.5)
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = load_jax_params(build_model(cfg, "cpu"),
                         jax.tree.map(np.asarray, jp))
    tokens = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 32))
    jl, jaux = jm.forward(jp, jnp.asarray(tokens))
    with torch.no_grad():
        tl, taux = tm.forward(torch.from_numpy(tokens))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=0)
    assert abs(float(taux) - float(jaux)) <= 1e-5
    with torch.no_grad():
        drop_free = tm.score(torch.from_numpy(tokens))
    # capacity 0.5 drops choices here: the drop-free logits differ
    assert float((drop_free - tl).abs().max()) > 1e-2
