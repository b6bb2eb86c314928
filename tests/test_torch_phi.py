"""PyTorch port, phi-3.5-moe with its MoE draft phi-mini-moe on the SP-MoE
main path, against the JAX reference.

* the config copies (and their ``reduced()``) are field-equal to the
  reference's; ``reduced_pair`` pairs every registered arch as the
  reference's launcher does (deepseek-v2-lite-16b with its MoE self-draft);
* ``moe_global`` (through the expert-FFN wrappers) against the reference's
  ``moe_global`` and the port's ``moe_ref``;
* the MoE draft through the weight bridge: prefill, decode blocks of 5 / 1 /
  3 tokens (logits, taps, caches) against ``DecoderLM``;
* serving: sd x spmoe emits the JAX engine's tokens; every decode x offload
  combination emits the port's own ``greedy_generate``; the runtime's
  counters after one request equal the reference's under synchronous
  prefetch (the draft-tap -> target-layer mapping); an all-hit fused round
  is bit-identical to each session's solo block; the target's experts are
  never read on the hot path while the draft keeps (and runs) its own; a
  target handed in as its own draft keeps its experts;
* the launcher serves ``--arch phi-3.5-moe --device cpu``.

The reduced pair in f32 (``reduced_pair``: 4 layers, d 64, 4 heads x 16,
8 experts top-2 of width 64 on both sides), the reference's weights
(target key 0, draft key 1), prompts made from a seed with numpy.
Tolerance: atol 1e-4 on logits and taps (four layers of f32 products summed
in another order), 1e-5 on one MoE layer's output and its aux loss."""
import dataclasses
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import phi_3_5_moe as jax_phi
from repro.core.engine import Engine as JaxEngine
from repro.core.engine import EngineConfig as JaxEngineConfig
from repro.core.engine import Request as JaxRequest
from repro.launch import serve as jax_launcher
from repro.models import moe as JMOE
from repro.models.registry import build_model as jax_build
from repro_torch.configs import phi_3_5_moe
from repro_torch.configs.registry import ARCHS
from repro_torch.core.engine import (DECODE_POLICIES, OFFLOAD_POLICIES,
                                     RUNTIME_COUNTER_KEYS, Engine,
                                     EngineConfig, Request)
from repro_torch.core.sd import greedy_generate
from repro_torch.kernels import cache_moe as K
from repro_torch.launch import serve as launcher
from repro_torch.models import moe as MOE
from repro_torch.models.convert import load_jax_params, params_from_jax
from repro_torch.models.registry import build_model

ARCH = "phi-3.5-moe"
ATOL = 1e-4
MOE_ATOL = 1e-5
TOK = 12
MAX_SEQ = 64


@pytest.fixture(scope="module")
def ph():
    jcfg, jdcfg = jax_launcher.reduced_pair(ARCH)
    cfg, dcfg = launcher.reduced_pair(ARCH)
    jtp = jax_build(jcfg).init(jax.random.PRNGKey(0))
    jdp = jax_build(jdcfg).init(jax.random.PRNGKey(1))
    target = load_jax_params(build_model(cfg, "cpu"),
                             jax.tree.map(np.asarray, jtp))
    draft = load_jax_params(build_model(dcfg, "cpu"),
                            jax.tree.map(np.asarray, jdp))
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, (1, n)) for n in (6, 4, 9)]
    refs = [greedy_generate(target, torch.from_numpy(p), TOK,
                            MAX_SEQ).tolist() for p in prompts]
    return dict(jcfg=jcfg, jdcfg=jdcfg, jtp=jtp, jdp=jdp, cfg=cfg, dcfg=dcfg,
                target=target, draft=draft, prompts=prompts, refs=refs)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=0)


def _ample(ph):
    return ph["cfg"].num_moe_layers * ph["cfg"].num_experts


def _engine(ph, decode="sd", offload="spmoe", slots=10, target=None,
            draft=None, **over):
    over.setdefault("draft_len", 3)
    over.setdefault("max_seq", MAX_SEQ)
    return Engine(EngineConfig(model=ph["cfg"], draft=ph["dcfg"],
                               decode=decode, offload=offload,
                               cache_slots=slots, **over),
                  target or ph["target"], draft or ph["draft"])


def _req(ph, i=0, n=TOK):
    return Request(prompt=ph["prompts"][i], max_new_tokens=n,
                   request_id=f"r{i}")


def _warm(eng):
    """Load every expert the engine has not: later blocks are all-hit."""
    rt = eng.runtime
    assert rt.prefetcher.drain(timeout=30)
    every = [(l, e) for l in range(rt.store.num_layers)
             for e in range(rt.store.num_experts)]
    missing = [k for k in every if not rt.cache.contains(k)]
    if missing:
        rt.cache.insert(missing, rt.store.fetch(missing))


# ---------------------------------------------------------------- configs


@pytest.mark.parametrize("which", ["CONFIG", "DRAFT_CONFIG"])
def test_configs_copy_the_reference(which):
    port, ref = getattr(phi_3_5_moe, which), getattr(jax_phi, which)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert dataclasses.asdict(port.reduced(dtype="float32")) == \
        dataclasses.asdict(ref.reduced(dtype="float32"))
    assert port.family == "moe" and port.is_moe
    assert (port.num_layers, port.d_model, port.num_heads,
            port.num_kv_heads, port.head_dim, port.vocab_size,
            port.num_experts, port.num_experts_per_tok) == \
        (32, 4096, 32, 8, 128, 32064, 16, 2)
    assert port.moe_d_ff == (6400 if which == "CONFIG" else 960)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_reduced_pair_is_the_references(arch):
    got = launcher.reduced_pair(arch)
    want = jax_launcher.reduced_pair(arch)
    for g, w in zip(got, want):
        assert dataclasses.asdict(g) == dataclasses.asdict(w), arch
    if arch in ("phi-3.5-moe", "deepseek-v2-lite-16b"):
        assert got[1].is_moe                # an MoE draft
    if arch == "deepseek-v2-lite-16b":
        assert got[1] == got[0]             # the self-draft


# ---------------------------------------------------------------- model


@pytest.mark.parametrize("B,S", [(1, 1), (1, 5), (2, 9)])
def test_moe_global_matches_jax_and_moe_ref(ph, B, S):
    """A one-token draft step, a verify block and a prefill-sized batch:
    the routed experts through the wrappers (their plain versions here)."""
    jcfg, cfg = ph["jdcfg"], ph["dcfg"]
    jp = JMOE.init_moe(jax.random.PRNGKey(5), jcfg, jnp.float32)
    p = SimpleNamespace(**{n: torch.from_numpy(np.asarray(a).copy())
                           for n, a in jp.items()})
    x = np.random.default_rng(6).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    want, jaux = JMOE.moe_global(jp, jnp.asarray(x), jcfg)
    before = (K.gate_up.launches, K.down.launches)
    got, aux = MOE.moe_global(p, torch.from_numpy(x), cfg)
    assert (K.gate_up.launches, K.down.launches) == before   # no kernel
    _close(got, want, MOE_ATOL)
    _close(aux, jaux, MOE_ATOL)
    _close(got, MOE.moe_ref(p, torch.from_numpy(x), cfg), MOE_ATOL)


def test_bridge_carries_the_moe_draft(ph):
    state = params_from_jax(jax.tree.map(np.asarray, ph["jdp"]))
    assert set(state) == set(ph["draft"].state_dict())
    dcfg = ph["dcfg"]
    for l in range(dcfg.num_layers):
        for n in ("gate", "wg", "wu", "wd"):
            assert f"layers.{l}.moe.{n}" in state
    assert tuple(state["layers.0.moe.wd"].shape) == \
        (dcfg.num_experts, dcfg.moe_d_ff, dcfg.d_model)
    assert torch.equal(ph["draft"].layers[1].moe.wg, state["layers.1.moe.wg"])


@pytest.mark.parametrize("which", ["target", "draft"])
def test_prefill_and_decode_blocks_match_jax(ph, which):
    """Logits, the taps and every cache after each block."""
    jcfg = dataclasses.replace(ph["jcfg"] if which == "target"
                               else ph["jdcfg"], capacity_factor=8.0)
    jm = jax_build(jcfg)
    jp = ph["jtp"] if which == "target" else ph["jdp"]
    tm = ph[which]
    rng = np.random.default_rng(7)
    prompt = rng.integers(0, 256, (1, 10))
    jl, jc = jm.prefill(jp, jnp.asarray(prompt), 48)
    tl, tc = tm.prefill(torch.from_numpy(prompt), 48)
    _close(tl, jl)
    pos = 10
    for n in (5, 1, 3):
        blk = rng.integers(0, 256, (1, n))
        jl, jc, jt = jm.decode_step(jp, jc, jnp.asarray(blk), pos,
                                    collect_taps=True)
        tl, tc, tt = tm.decode_step(tc, torch.from_numpy(blk), pos,
                                    collect_taps=True)
        _close(tl, jl)
        assert set(tt) == set(jt) == {"layers"}
        _close(tt["layers"], jt["layers"])
        for l, c in enumerate(tc["layers"]):
            for k in ("k", "v", "pos_map"):
                _close(c[k], jc["layers"][k][l])
        pos += n


# -------------------------------------------------------------- serving


def test_sd_spmoe_matches_jax_engine_tokens(ph):
    """Both engines prefetch synchronously (``prefetch_mode="vanilla"``), so
    each block's hit/miss split follows from the request alone."""
    common = dict(decode="sd", offload="spmoe", cache_slots=10, draft_len=3,
                  max_seq=MAX_SEQ, prefetch_mode="vanilla")
    with JaxEngine(JaxEngineConfig(model=ph["jcfg"], draft=ph["jdcfg"],
                                   **common), ph["jtp"], ph["jdp"]) as jeng:
        want = jeng.submit(JaxRequest(prompt=jnp.asarray(ph["prompts"][0]),
                                      max_new_tokens=TOK)).tokens
    with _engine(ph, prefetch_mode="vanilla") as eng:
        got = eng.submit(_req(ph))
    assert got.tokens == want == ph["refs"][0]
    assert got.metrics.on_demand_loads > 0 and got.metrics.evictions > 0


@pytest.mark.parametrize("offload", OFFLOAD_POLICIES)
@pytest.mark.parametrize("decode", DECODE_POLICIES)
def test_lossless_against_the_ports_greedy(ph, decode, offload):
    with _engine(ph, decode=decode, offload=offload,
                 max_draft_len=5) as eng:
        res = eng.submit(_req(ph, 2))
    assert res.tokens == ph["refs"][2], (decode, offload)
    assert res.metrics.tokens == TOK


def test_runtime_counters_equal_the_references(ph):
    """After one request, and after ``reset_stats`` and one more, every
    runtime counter (hits, prefetched, on-demand loads, ...) equals the
    reference engine's driven the same way with synchronous prefetch: the
    draft's taps predict the same target layers' experts."""
    common = dict(decode="sd", offload="spmoe", cache_slots=10, draft_len=3,
                  max_seq=MAX_SEQ, prefetch_mode="vanilla")
    p0, p1 = (jnp.asarray(ph["prompts"][i]) for i in (0, 1))
    with JaxEngine(JaxEngineConfig(model=ph["jcfg"], draft=ph["jdcfg"],
                                   **common), ph["jtp"], ph["jdp"]) as jeng:
        jeng.submit(JaxRequest(prompt=p0, max_new_tokens=8))
        want_first = dict(jeng.runtime.counters())
        jeng.reset_stats()
        jeng.submit(JaxRequest(prompt=p1, max_new_tokens=8))
        want = dict(jeng.runtime.counters())
    with _engine(ph, prefetch_mode="vanilla") as eng:
        eng.submit(_req(ph, 0, n=8))
        got_first = eng.runtime.counters()
        eng.reset_stats()
        eng.submit(_req(ph, 1, n=8))
        got = eng.runtime.counters()
    assert got_first == want_first
    assert got == want
    assert got_first["prefetched"] > 0 and got_first["hits"] > 0
    assert set(got) == set(RUNTIME_COUNTER_KEYS)


def test_draft_taps_map_layer_to_layer(ph):
    with _engine(ph) as eng:
        _, dc = ph["draft"].prefill(torch.from_numpy(ph["prompts"][0]), 32)
        _, _, taps = ph["draft"].decode_step(dc, torch.tensor([[3]]), 6,
                                             collect_taps=True)
        stack = eng.runtime._draft_taps_for_moe(taps)
    assert stack.shape[0] == ph["cfg"].num_moe_layers
    assert torch.equal(stack, taps["layers"])


def test_fused_round_is_bit_identical_to_solo_blocks(ph):
    """On one cache snapshot each session's logits, all-hit flag, history
    and activation count from the fused round equal its solo fast block bit
    for bit."""
    with _engine(ph, slots=_ample(ph)) as eng:
        rt = eng.runtime
        eng.submit(_req(ph, n=2))
        _warm(eng)
        sts = [rt.start_session(torch.from_numpy(p), 8)
               for p in ph["prompts"]]
        rng = np.random.default_rng(3)
        blocks = [torch.cat([st.cur, torch.from_numpy(
            rng.integers(0, ph["cfg"].vocab_size, (1, n)))], dim=1)
            for st, n in zip(sts, (3, 1, 4))]

        def caches():
            return [{s: [{n: t.clone() for n, t in c.items()}
                         for c in st.tcache[s]]
                     for s in ("dense_layers", "layers")} for st in sts]

        solo = [[o[0] for o in rt._fast_body([b], [st.pos], [tc],
                                             [st.history_dev])]
                for b, st, tc in zip(blocks, sts, caches())]
        logits, ok, hists, nact = rt._fast_body(
            blocks, [st.pos for st in sts], caches(),
            [st.history_dev for st in sts])
        for st in sts:
            rt.finish_session(st)
    assert ok.all()
    for j, (lg, ok1, h1, n1) in enumerate(solo):
        assert bool(ok1)
        assert torch.equal(logits[j], lg)
        assert torch.equal(hists[j], h1)
        assert torch.equal(nact[j], n1)


def test_target_experts_are_never_read_while_the_draft_runs_its_own(
        ph, monkeypatch):
    """Zeroing the target model's routed experts after the engine copied
    them to its host store changes no token; the draft keeps its experts
    and every draft step runs its MoE layers through ``moe_global``."""
    target = build_model(ph["cfg"], "cpu")
    target.load_state_dict(ph["target"].state_dict())
    calls = []
    orig = MOE.moe_global

    def spy(p, x, cfg):
        calls.append((cfg.name, x.shape[1]))
        return orig(p, x, cfg)

    monkeypatch.setattr(MOE, "moe_global", spy)
    with _engine(ph, slots=_ample(ph), target=target) as eng:
        for blk in target.layers:
            for n in ("wg", "wu", "wd"):
                getattr(blk.moe, n).data.zero_()
        res = eng.submit(_req(ph))
        drafted = res.metrics.drafted
    assert res.tokens == ph["refs"][0]
    assert all(blk.moe.wu.abs().sum() > 0 for blk in ph["draft"].layers)
    dname, L = ph["dcfg"].name, ph["dcfg"].num_layers
    assert all(name == dname for name, _ in calls)   # never the target's
    steps = sum(1 for _, s in calls if s == 1)
    assert drafted > 0 and steps == drafted * L


def test_engine_drops_only_the_targets_experts(ph):
    """An engine that builds both models hands the target's experts to its
    host store and frees them; the MoE draft keeps its own."""
    with Engine(EngineConfig(model=ph["cfg"], draft=ph["dcfg"], decode="sd",
                             offload="spmoe", cache_slots=10, draft_len=3,
                             max_seq=MAX_SEQ), device="cpu") as eng:
        assert all(b.moe.wu.numel() == 0 for b in eng.target.layers)
        assert all(b.moe.wu.shape == (ph["dcfg"].num_experts,
                                      ph["dcfg"].d_model,
                                      ph["dcfg"].moe_d_ff)
                   for b in eng.draft.layers)
        res = eng.submit(_req(ph, n=6))
    assert len(res.tokens) == 6 and res.metrics.drafted > 0


def test_target_handed_in_as_its_own_draft_keeps_its_experts(ph):
    """The target module as its own draft: the engine does not drop the
    experts its draft steps read, and serving stays lossless."""
    target = build_model(ph["cfg"], "cpu")
    target.load_state_dict(ph["target"].state_dict())
    before = {n: t.clone() for n, t in target.state_dict().items()}
    with Engine(EngineConfig(model=ph["cfg"], draft=ph["cfg"], decode="sd",
                             offload="spmoe", cache_slots=10, draft_len=3,
                             max_seq=MAX_SEQ), target, target) as eng:
        assert eng.draft is eng.target
        res = eng.submit(_req(ph))
    assert res.tokens == ph["refs"][0]
    assert res.metrics.accepted > 0                  # it drafts its greedy
    for n, t in target.state_dict().items():
        assert torch.equal(t, before[n]), n


def test_launcher_serves_phi(capsys, monkeypatch):
    cfg, dcfg = launcher.reduced_pair(ARCH)
    assert dcfg.name == "phi-mini-moe-draft-reduced" and dcfg.is_moe
    monkeypatch.setattr(sys, "argv", [
        "serve", "--device", "cpu", "--arch", ARCH, "--tokens", "4",
        "--requests", "2", "--cache-slots", "12"])
    launcher.main()
    out = capsys.readouterr().out
    for rid in ("req-0", "req-1"):
        assert f"[{rid}] finish=length" in out
    assert "cumulative: requests=2 tokens=8" in out
