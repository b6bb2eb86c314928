"""PyTorch port, gelu experts on the CPU: ``cache_moe(wg=None)`` (the
up-gelu stage, then the down stage) against the reference's Pallas kernels
in interpret mode, and a gelu-expert mixtral (the config's
``ffn_activation="gelu"``, which both packages allow; not a published
model) built, stored and served sd x spmoe against the reference.  The CUDA
stage itself is tested on a card (test_torch_cuda.py, chip_smoke.py).

The reference's ``init_moe`` draws an expert gate projection ``wg`` for
every activation, and its offload store carries whatever the tree holds, so
its engine would run a gelu config's experts as swiglu ones through
``cache_moe(..., wg)``.  The port builds no ``wg`` for gelu experts (and the
bridge does not copy it); the engine comparison hands the reference the
tree without it, so that both engines run gelu experts.

Inputs are made from a seed with numpy and fed to both packages; kernel
tolerances are the reference's own (tests/test_offload_hotpath.py: f32 atol
2e-5, bf16 2e-2, rtol 2e-2)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_config
from repro.core.engine import Engine as JaxEngine
from repro.core.engine import EngineConfig as JaxEngineConfig
from repro.core.engine import Request as JaxRequest
from repro.core.engine import derive_draft_config as jax_derive
from repro.kernels.cache_moe import cache_moe as jax_cache_moe
from repro.models.registry import build_model as jax_build
from repro_torch.configs.registry import get_config
from repro_torch.core.engine import (Engine, EngineConfig, Request,
                                     derive_draft_config)
from repro_torch.core.sd import greedy_generate
from repro_torch.kernels import cache_moe as K
from repro_torch.kernels import ops
from repro_torch.kernels import ref as R
from repro_torch.models.convert import load_jax_params
from repro_torch.models.registry import build_model

torch.set_num_threads(1)  # pytest -n: several processes share the cores


def _tol(dtype):
    return 2e-2 if dtype == "bfloat16" else 2e-5


def _inputs(T, k, S, d, f, dtype, seed):
    rng = np.random.default_rng(seed)
    arrs = {"x": rng.standard_normal((T, d)),
            "wu": rng.standard_normal((S, d, f)) * 0.1,
            "wd": rng.standard_normal((S, f, d)) * 0.1,
            "weights": rng.uniform(size=(T, k))}
    jx = {n: jnp.asarray(a.astype(np.float32), jnp.dtype(dtype))
          for n, a in arrs.items()}
    tx = {n: torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        getattr(torch, dtype)) for n, a in jx.items()}
    slots = rng.integers(-1, S, (T, k)).astype(np.int32)    # with misses
    slots[1] = slots[1, 0] if slots[1, 0] >= 0 else 0        # a repeat
    return jx, tx, slots


@pytest.mark.parametrize("T,k,S,d,f", [
    (6, 2, 5, 32, 64),                # the reference test's shape
    (5, 2, 12, 64, 128),              # a verify block over a 12-slot pool
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cache_moe_gelu_matches_jax_kernel(T, k, S, d, f, dtype):
    jx, tx, slots = _inputs(T, k, S, d, f, dtype, 0)
    want = jax_cache_moe(jx["x"], jnp.asarray(slots), jx["weights"],
                         jx["wu"], jx["wd"], None, interpret=True)
    si = torch.from_numpy(slots)
    # the ops entry (plain version whole) and the staged route (up-gelu and
    # down plain versions over the slot groups)
    for fn in (ops.cache_moe, K.cache_moe):
        got = fn(tx["x"], si, tx["weights"], tx["wu"], tx["wd"], None)
        assert got.dtype == tx["x"].dtype and got.shape == tx["x"].shape
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   atol=_tol(dtype), rtol=2e-2)


def test_up_gelu_plain_version_is_tanh_gelu_per_row():
    """Stage 1 alone: each sorted row is gelu_tanh(x[token] @ wu[slot]) as
    ``jax.nn.gelu`` computes it (its default is the tanh form); rows of no
    group stay 0; no kernel launch for CPU tensors."""
    _, tx, slots = _inputs(5, 2, 6, 32, 64, "float32", 1)
    si = torch.from_numpy(slots)
    g = K.slot_groups(si, 6)
    before = K.up_gelu.launches
    h = K.up_gelu(tx["x"], g, tx["wu"])
    assert K.up_gelu.launches == before
    flat = slots.reshape(-1)
    order = np.argsort(np.where(flat >= 0, flat, 6), kind="stable")
    for p, c in enumerate(order):
        if flat[c] < 0:
            assert torch.equal(h[p], torch.zeros_like(h[p]))
            continue
        pre = tx["x"][c // 2].numpy() @ tx["wu"][flat[c]].numpy()
        np.testing.assert_allclose(h[p].numpy(),
                                   np.asarray(jax.nn.gelu(pre)),
                                   atol=1e-6, rtol=1e-5)


def _gelu_pair():
    jcfg = dataclasses.replace(jax_config("mixtral-8x7b").reduced(
        dtype="float32"), ffn_activation="gelu", attn_impl="kernel")
    cfg = dataclasses.replace(get_config("mixtral-8x7b").reduced(
        dtype="float32"), ffn_activation="gelu", attn_impl="kernel")
    jtp = jax_build(jcfg).init(jax.random.PRNGKey(0))
    jdp = jax_build(jax_derive(jcfg)).init(jax.random.PRNGKey(1))
    target = load_jax_params(build_model(cfg, "cpu"),
                             jax.tree.map(np.asarray, jtp))
    draft = load_jax_params(build_model(derive_draft_config(cfg), "cpu"),
                            jax.tree.map(np.asarray, jdp))
    # the reference's unused gate projection (see the module docstring)
    jtp["layers"]["moe"] = {n: w for n, w in jtp["layers"]["moe"].items()
                            if n != "wg"}
    return (jcfg, jtp, jdp), (cfg, target, draft)


def test_gelu_moe_builds_stores_and_routes_without_wg(monkeypatch):
    """A gelu-expert MoE builds no ``wg``, the bridge skips the
    reference's, the host store and the slot pool carry ``wu`` / ``wd``
    only, and the runtime calls ``cache_moe`` with ``wg=None``."""
    _, (cfg, target, draft) = _gelu_pair()
    assert not hasattr(target.layers[0].moe, "wg")
    calls = []
    orig = ops.cache_moe

    def spy(x, slot_ids, weights, wu, wd, wg=None):
        calls.append(wg)
        return orig(x, slot_ids, weights, wu, wd, wg)
    monkeypatch.setattr(ops, "cache_moe", spy)
    with Engine(EngineConfig(model=cfg, draft=derive_draft_config(cfg),
                             decode="sd", offload="spmoe", cache_slots=8,
                             draft_len=2, max_seq=32,
                             prefetch_mode="vanilla"), target, draft) as eng:
        assert eng.runtime.store.names == ["wu", "wd"]
        assert sorted(eng.runtime.cache.bufs) == ["wd", "wu"]
        res = eng.submit(Request(prompt=[1, 2, 3, 4], max_new_tokens=4))
    assert len(res.tokens) == 4
    assert calls and all(wg is None for wg in calls)


def test_gelu_engine_matches_jax_engine():
    """sd x spmoe over the reduced gelu-expert mixtral, prefetching
    synchronously, in both packages: the same tokens, which are also the
    port's own greedy tokens."""
    (jcfg, jtp, jdp), (cfg, target, draft) = _gelu_pair()
    prompt = np.random.default_rng(7).integers(0, cfg.vocab_size, (1, 8))
    common = dict(decode="sd", offload="spmoe", cache_slots=8, draft_len=3,
                  max_seq=64, prefetch_mode="vanilla")
    with JaxEngine(JaxEngineConfig(model=jcfg, draft=jax_derive(jcfg),
                                   **common), jtp, jdp) as jeng:
        want = jeng.submit(JaxRequest(prompt=jnp.asarray(prompt),
                                      max_new_tokens=12)).tokens
    with Engine(EngineConfig(model=cfg, draft=derive_draft_config(cfg),
                             **common), target, draft) as eng:
        got = eng.submit(Request(prompt=prompt, max_new_tokens=12))
    assert got.tokens == want
    assert got.tokens == greedy_generate(target, torch.from_numpy(prompt),
                                         12, 64).tolist()
