"""PyTorch port, deepseek-v2-lite-16b on the SP-MoE main path against the JAX
reference: a leading dense layer (``dense_layers``), MLA attention and a
shared expert in every MoE layer.

* the weight bridge's names (``dense_layers.0.*``,
  ``layers.<l>.moe.shared.*``) and ``moe_global`` / ``moe_ref`` with a
  shared expert;
* ``DecoderLM``: prefill, then decode blocks of 5 / 1 / 3 tokens (logits,
  the taps of both stacks, every cache) and the full-sequence forward;
* serving: sd x spmoe emits the JAX engine's tokens; every {greedy, sd,
  sd-adaptive} x {none, spmoe, on-demand} combination emits the port's own
  ``greedy_generate``; a fast verify block syncs at most twice; an all-hit
  fused round is bit-identical to each session's solo block; concurrent
  serving emits the greedy tokens with <= 2 syncs per fused round; the hot
  path never reads the resident routed experts; the host store and the
  predictor hold the MoE layers only; draft layer l + 1 predicts MoE layer
  l; ``Engine.reset_stats`` leaves the reference's counters;
* the MoE self-draft (the reference's pairing): its taps hold its MoE
  layers only and map layer to layer; sd x spmoe against the JAX engine's
  tokens and counters;
* the launcher serves the reference's reduced pair (the MoE self-draft).

Reduced deepseek in f32 (``reduced(dtype="float32", num_layers=3)``: 1 dense
+ 2 MoE layers, 8 experts top-2, 1 shared, MLA H 4 / latent 32) with the
reference's weights, inputs made from a seed with numpy.  Tolerance: atol
1e-4 on logits and taps (three layers of f32 products summed in another
order), 1e-5 on one MoE layer's output."""
import dataclasses
import sys
from types import SimpleNamespace

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
from repro.launch import serve as jax_launcher
from repro.models import moe as JMOE
from repro.models.registry import build_model as jax_build
from repro_torch.configs.registry import get_config
from repro_torch.core.engine import (DECODE_POLICIES, RUNTIME_COUNTER_KEYS,
                                     Engine, EngineConfig, Request,
                                     derive_draft_config)
from repro_torch.core.sd import greedy_generate
from repro_torch.launch import serve as launcher
from repro_torch.models import moe as MOE
from repro_torch.models.convert import load_jax_params, params_from_jax
from repro_torch.models.registry import build_model

ARCH = "deepseek-v2-lite-16b"
ATOL = 1e-4
MOE_ATOL = 1e-5
TOK = 12
MAX_SEQ = 64


def _cfgs(**over):
    over = {"dtype": "float32", "num_layers": 3, **over}
    return jax_config(ARCH).reduced(**over), get_config(ARCH).reduced(**over)


@pytest.fixture(scope="module")
def ds():
    jcfg, cfg = _cfgs()
    jdcfg, dcfg = jax_derive(jcfg), derive_draft_config(cfg)
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


def _ample(ds):
    return ds["cfg"].num_moe_layers * ds["cfg"].num_experts


def _engine(ds, decode="sd", offload="spmoe", slots=9, **over):
    over.setdefault("draft_len", 3)
    over.setdefault("max_seq", MAX_SEQ)
    return Engine(EngineConfig(model=ds["cfg"], draft=ds["dcfg"],
                               decode=decode, offload=offload,
                               cache_slots=slots, **over),
                  ds["target"], ds["draft"])


def _req(ds, i=0, n=TOK, **kw):
    return Request(prompt=ds["prompts"][i], max_new_tokens=n,
                   request_id=f"r{i}", **kw)


def _warm(eng):
    """Load every expert the engine has not: later blocks are all-hit."""
    rt = eng.runtime
    assert rt.prefetcher.drain(timeout=30)
    every = [(l, e) for l in range(rt.store.num_layers)
             for e in range(rt.store.num_experts)]
    missing = [k for k in every if not rt.cache.contains(k)]
    if missing:
        rt.cache.insert(missing, rt.store.fetch(missing))


# ---------------------------------------------------------------- model


def test_bridge_names_hold_dense_layers_and_shared_experts(ds):
    state = params_from_jax(jax.tree.map(np.asarray, ds["jtp"]))
    assert set(state) == set(ds["target"].state_dict())
    for name in ("dense_layers.0.ffn.wg", "dense_layers.0.attn.wdkv",
                 "layers.0.moe.shared.wg", "layers.1.moe.shared.wd",
                 "layers.1.attn.wuv", "layers.1.moe.gate"):
        assert name in state, name
    assert not any(n.startswith("dense_layers.1.") for n in state)
    assert not any(n.startswith("layers.2.") for n in state)
    assert "dense_layers.0.moe.gate" not in state
    width = ds["cfg"].num_shared_experts * ds["cfg"].moe_d_ff
    assert tuple(state["layers.0.moe.shared.wu"].shape) == \
        (ds["cfg"].d_model, width)


@pytest.mark.parametrize("fn", ["moe_global", "moe_ref"])
def test_moe_with_a_shared_expert_matches_jax(ds, fn):
    jcfg, cfg = ds["jcfg"], ds["cfg"]
    jp = JMOE.init_moe(jax.random.PRNGKey(5), jcfg, jnp.float32)
    t = {n: torch.from_numpy(np.asarray(a).copy())
         for n, a in jp.items() if n != "shared"}
    p = SimpleNamespace(**t, shared=SimpleNamespace(**{
        n: torch.from_numpy(np.asarray(a).copy())
        for n, a in jp["shared"].items()}))
    x = np.random.default_rng(6).standard_normal(
        (2, 5, cfg.d_model)).astype(np.float32)
    if fn == "moe_global":
        want, jaux = JMOE.moe_global(jp, jnp.asarray(x), jcfg)
        got, aux = MOE.moe_global(p, torch.from_numpy(x), cfg)
        _close(aux, jaux, MOE_ATOL)
    else:
        want = JMOE.moe_ref(jp, jnp.asarray(x), jcfg)
        got = MOE.moe_ref(p, torch.from_numpy(x), cfg)
    _close(got, want, MOE_ATOL)
    no_shared = dataclasses.replace(cfg, num_shared_experts=0)
    routed = getattr(MOE, fn)(p, torch.from_numpy(x), no_shared)
    routed = routed[0] if fn == "moe_global" else routed
    assert not torch.allclose(got, routed)          # the shared part counts


@pytest.mark.parametrize("which", ["target", "draft"])
def test_prefill_and_decode_blocks_match_jax(ds, which):
    """Logits, the taps of both stacks and every cache after each block
    (the draft is the dense MLA sibling: one stack)."""
    jcfg = dataclasses.replace(ds["jcfg"] if which == "target"
                               else ds["jdcfg"], capacity_factor=8.0)
    jm = jax_build(jcfg)
    jp = ds["jtp"] if which == "target" else ds["jdp"]
    tm = ds[which]
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
        assert set(tt) == set(jt)
        for name in jt:
            _close(tt[name], jt[name])
            for l, c in enumerate(tc[name]):
                for k in ("c_kv", "k_rope", "pos_map"):
                    _close(c[k], jc[name][k][l])
        pos += n


def test_forward_matches_jax(ds):
    """Sequences of 8 tokens: the reference routes them drop-free
    (``moe_global``), as the port does at every length."""
    jm = jax_build(dataclasses.replace(ds["jcfg"], capacity_factor=8.0))
    tokens = np.random.default_rng(8).integers(0, 256, (2, 8))
    jl, jaux = jm.forward(ds["jtp"], jnp.asarray(tokens))
    tl, taux = ds["target"].forward(torch.from_numpy(tokens))
    _close(tl, jl)
    _close(taux, jaux, MOE_ATOL)


def test_reduced_config_builds_with_its_stacks(ds):
    cfg = ds["cfg"]
    m = build_model(get_config(ARCH).reduced(dtype="float32"), "cpu")
    assert (len(m.dense_layers), len(m.layers)) == (1, 3)
    assert all(b.kind == "moe" for b in m.layers)
    assert m.dense_layers[0].kind == "dense"
    assert hasattr(m.layers[0].moe, "shared")
    dcfg = derive_draft_config(cfg)
    assert (dcfg.num_experts, dcfg.num_shared_experts,
            dcfg.first_dense_layers, dcfg.use_mla) == (0, 0, 0, True)
    assert dcfg.num_layers == cfg.num_layers


# -------------------------------------------------------------- serving


def test_sd_spmoe_matches_jax_engine_tokens(ds):
    """Both engines prefetch synchronously (``prefetch_mode="vanilla"``), so
    each block's hit/miss split follows from the request alone."""
    common = dict(decode="sd", offload="spmoe", cache_slots=9, draft_len=3,
                  max_seq=MAX_SEQ, prefetch_mode="vanilla")
    with JaxEngine(JaxEngineConfig(model=ds["jcfg"], draft=ds["jdcfg"],
                                   **common), ds["jtp"], ds["jdp"]) as jeng:
        want = jeng.submit(JaxRequest(prompt=jnp.asarray(ds["prompts"][0]),
                                      max_new_tokens=TOK)).tokens
    with _engine(ds, prefetch_mode="vanilla") as eng:
        got = eng.submit(_req(ds))
    assert got.tokens == want == ds["refs"][0]
    assert got.metrics.on_demand_loads > 0 and got.metrics.evictions > 0


@pytest.mark.parametrize("offload", ["none", "spmoe", "on-demand"])
@pytest.mark.parametrize("decode", DECODE_POLICIES)
def test_lossless_against_the_ports_greedy(ds, decode, offload):
    with _engine(ds, decode=decode, offload=offload,
                 max_draft_len=5) as eng:
        res = eng.submit(_req(ds))
    assert res.tokens == ds["refs"][0], (decode, offload)
    assert res.metrics.tokens == TOK


def test_fast_path_syncs_at_most_twice_per_block(ds):
    """Every expert cached: a fast verify block syncs once inside
    ``_verify_block`` (the all-hit flag) and once more for the accept /
    reject argmax, and never falls back."""
    with _engine(ds, slots=_ample(ds)) as eng:
        rt = eng.runtime
        eng.submit(_req(ds, n=4))
        _warm(eng)
        per_block, per_turn = [], []
        orig_vb, orig_turn = rt._verify_block, rt.session_turn

        def spy_vb(tokens, pos, tcache):
            s0, f0 = rt.host_syncs, rt.fast_blocks
            out = orig_vb(tokens, pos, tcache)
            per_block.append((rt.host_syncs - s0, rt.fast_blocks > f0))
            return out

        def spy_turn(st):
            s0, f0 = rt.host_syncs, rt.fast_blocks
            out = orig_turn(st)
            if rt.fast_blocks > f0:
                per_turn.append(rt.host_syncs - s0)
            return out

        rt._verify_block, rt.session_turn = spy_vb, spy_turn
        res = eng.submit(_req(ds))
        assert rt.cache.check_invariants()
    fast = [n for n, is_fast in per_block if is_fast]
    assert fast and max(fast) == 1
    assert per_turn and max(per_turn) <= 2
    assert res.metrics.fast_blocks == len(fast) == len(per_block)
    assert res.metrics.fast_fallbacks == 0
    assert res.tokens == ds["refs"][0]


def test_fused_round_is_bit_identical_to_solo_blocks(ds):
    """On one cache snapshot each session's logits, all-hit flag, history
    and activation count from the fused round equal its solo fast block bit
    for bit: the dense layer and the shared expert run per session."""
    with _engine(ds, slots=_ample(ds)) as eng:
        rt = eng.runtime
        eng.submit(_req(ds, n=2))
        _warm(eng)
        sts = [rt.start_session(torch.from_numpy(p), 8)
               for p in ds["prompts"]]
        rng = np.random.default_rng(3)
        blocks = [torch.cat([st.cur, torch.from_numpy(
            rng.integers(0, ds["cfg"].vocab_size, (1, n)))], dim=1)
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


def test_concurrent_serving_emits_greedy_with_two_syncs_a_round(ds):
    """Three ragged requests two at a time on an ample cache: each emits
    its greedy tokens; every fused round syncs twice and calls the expert
    FFN once per MoE layer."""
    with _engine(ds, slots=_ample(ds)) as eng:
        rt = eng.runtime
        eng.submit(_req(ds, n=2))
        _warm(eng)
        moe_calls, per_round = [], []
        orig_moe, orig_fused = rt._moe_apply, rt._round_fused

        def count_moe(*a):
            moe_calls.append(1)
            return orig_moe(*a)

        def spy_fused(fused, *a):
            m0, s0 = len(moe_calls), rt.host_syncs
            orig_fused(fused, *a)
            per_round.append((len(fused), len(moe_calls) - m0,
                              rt.host_syncs - s0))

        rt._moe_apply, rt._round_fused = count_moe, spy_fused
        res = eng.serve_all([_req(ds, i) for i in range(3)], concurrency=2)
    for r, ref in zip(res, ds["refs"]):
        assert r.tokens == ref
    assert per_round
    for n, moe, syncs in per_round:
        assert (n, moe, syncs) == (2, ds["cfg"].num_moe_layers, 2)


def test_hot_path_never_reads_resident_expert_weights(ds):
    """Zeroing the model's routed expert tensors after the engine copied
    them to its host store changes no token (the dense FFN and the shared
    experts stay: the hot path computes them from the model)."""
    cfg = ds["cfg"]
    target = build_model(cfg, "cpu")
    target.load_state_dict(ds["target"].state_dict())
    with Engine(EngineConfig(model=cfg, draft=ds["dcfg"], decode="sd",
                             offload="spmoe", cache_slots=_ample(ds),
                             draft_len=3, max_seq=MAX_SEQ),
                target, ds["draft"]) as eng:
        for blk in target.layers:
            for n in ("wg", "wu", "wd"):
                getattr(blk.moe, n).data.zero_()
        res = eng.submit(_req(ds))
    assert res.tokens == ds["refs"][0]


def test_store_and_predictor_hold_only_the_moe_layers(ds):
    with _engine(ds) as eng:
        rt = eng.runtime
        L, E = ds["cfg"].num_moe_layers, ds["cfg"].num_experts
        assert (rt.store.num_layers, rt.store.num_experts) == (L, E)
        assert rt.predictor.gates.shape[0] == L
        for l in range(L):
            blk = ds["target"].layers[l]
            assert torch.equal(rt.predictor.gates[l], blk.moe.gate)
            for n in ("wg", "wu", "wd"):
                for e in (0, E - 1):
                    assert torch.equal(rt.store.expert(n, l, e),
                                       getattr(blk.moe, n)[e])
        assert rt.cache.bufs["wg"].shape[1:] == \
            (ds["cfg"].d_model, ds["cfg"].moe_d_ff)


def test_draft_layer_after_the_dense_one_predicts_each_moe_layer():
    """A 4-layer target (1 dense + 3 MoE) and its 4-layer draft: the tap
    used for MoE layer l is the draft's layer l + 1."""
    _, cfg = _cfgs(num_layers=4)
    dcfg = derive_draft_config(cfg)
    target = build_model(cfg, "cpu", seed=0)
    draft = build_model(dcfg, "cpu", seed=1)
    with Engine(EngineConfig(model=cfg, draft=dcfg, decode="sd",
                             offload="spmoe", cache_slots=6, draft_len=2,
                             max_seq=32), target, draft) as eng:
        rt = eng.runtime
        prompt = torch.tensor([[5, 6, 7, 8]])
        _, dc = draft.prefill(prompt, 32)
        _, _, taps = draft.decode_step(dc, prompt[:, :1], 4,
                                       collect_taps=True)
        stack = rt._draft_taps_for_moe(taps)
        assert taps["layers"].shape[0] == 4 and stack.shape[0] == 3
        for l in range(3):
            assert torch.equal(stack[l], taps["layers"][l + 1])
        res = eng.submit(Request(prompt=prompt, max_new_tokens=6))
    assert res.tokens == greedy_generate(target, prompt, 6, 32).tolist()


def test_reset_stats_leaves_the_reference_counters(ds):
    """A warm engine after ``reset_stats``: every counter is 0, and after
    one more request each counter equals the reference engine's, reset and
    driven the same way (synchronous prefetch on both sides)."""
    common = dict(decode="sd", offload="spmoe", cache_slots=9, draft_len=3,
                  max_seq=MAX_SEQ, prefetch_mode="vanilla")
    p0, p1 = (jnp.asarray(ds["prompts"][i]) for i in (0, 2))
    with JaxEngine(JaxEngineConfig(model=ds["jcfg"], draft=ds["jdcfg"],
                                   **common), ds["jtp"], ds["jdp"]) as jeng:
        jeng.submit(JaxRequest(prompt=p0, max_new_tokens=6))
        jeng.reset_stats()
        want_zero = dict(jeng.runtime.counters())
        jeng.submit(JaxRequest(prompt=p1, max_new_tokens=6))
        want = dict(jeng.runtime.counters())
        want_cum = jeng.metrics().as_dict()
    with _engine(ds, prefetch_mode="vanilla") as eng:
        eng.submit(_req(ds, 0, n=6))
        eng.reset_stats()
        got_zero = eng.runtime.counters()
        assert eng.metrics().requests == 0
        assert (eng.runtime.verify_rounds, eng.runtime.round_launches) == \
            (0, 0)
        eng.submit(_req(ds, 2, n=6))
        got = eng.runtime.counters()
        cum = eng.metrics().as_dict()
    assert got_zero == want_zero
    assert all(v == 0 for v in got_zero.values())
    assert got == want
    assert got["verify_blocks"] > 0
    for k in ("requests", "tokens") + RUNTIME_COUNTER_KEYS:
        assert cum[k] == want_cum[k], k


def test_moe_self_draft_serves_as_the_reference_does(ds):
    """The reference's pairing: the target's own architecture as its draft
    (an MoE draft with a dense layer and shared experts, weights from key
    1).  Its taps hold only its MoE layers, and MoE layer l predicts target
    MoE layer l; sd x spmoe emits the JAX engine's tokens and the port's
    greedy, and the runtime's counters equal the reference's under
    synchronous prefetch."""
    jcfg, cfg = ds["jcfg"], ds["cfg"]
    jsp = jax_build(jcfg).init(jax.random.PRNGKey(1))
    self_draft = load_jax_params(build_model(cfg, "cpu"),
                                 jax.tree.map(np.asarray, jsp))
    assert self_draft.layers[0].moe.wu.numel() > 0
    common = dict(decode="sd", offload="spmoe", cache_slots=9, draft_len=3,
                  max_seq=MAX_SEQ, prefetch_mode="vanilla")
    with JaxEngine(JaxEngineConfig(model=jcfg, draft=jcfg, **common),
                   ds["jtp"], jsp) as jeng:
        want = jeng.submit(JaxRequest(prompt=jnp.asarray(ds["prompts"][0]),
                                      max_new_tokens=TOK)).tokens
        want_counters = dict(jeng.runtime.counters())
    with Engine(EngineConfig(model=cfg, draft=cfg, **common), ds["target"],
                self_draft) as eng:
        prompt = torch.from_numpy(ds["prompts"][0])
        _, dc = self_draft.prefill(prompt, MAX_SEQ)
        _, _, taps = self_draft.decode_step(dc, prompt[:, :1], 6,
                                            collect_taps=True)
        stack = eng.runtime._draft_taps_for_moe(taps)
        got = eng.submit(_req(ds))
        got_counters = eng.runtime.counters()
    assert set(taps) == {"dense_layers", "layers"}
    assert taps["layers"].shape[0] == cfg.num_moe_layers
    assert torch.equal(stack, taps["layers"])
    assert got.tokens == want == ds["refs"][0]
    assert got_counters == want_counters
    assert got.metrics.drafted > 0 and got.metrics.prefetched > 0


def test_launcher_serves_the_reduced_pair(capsys, monkeypatch):
    """The reference's pair: the reduced target and, as its draft, the
    reduced registered draft, which is the target itself (the MoE
    self-draft)."""
    cfg, dcfg = launcher.reduced_pair(ARCH)
    assert cfg.is_moe and cfg.use_mla and cfg.first_dense_layers == 1
    for got, want in zip((cfg, dcfg), jax_launcher.reduced_pair(ARCH)):
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dcfg == cfg and dcfg.is_moe and dcfg.num_shared_experts == 1
    monkeypatch.setattr(sys, "argv", [
        "serve", "--device", "cpu", "--arch", ARCH, "--tokens", "4",
        "--requests", "2", "--cache-slots", "12"])
    launcher.main()
    out = capsys.readouterr().out
    for rid in ("req-0", "req-1"):
        assert f"[{rid}] finish=length" in out
    assert "cumulative: requests=2 tokens=8" in out
