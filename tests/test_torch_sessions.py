"""PyTorch port, concurrent serving on the CPU: ``Engine.serve`` /
``serve_all`` and the batched cross-session verify round
(``OffloadEngine.session_turns`` -> ``_round_fused`` ->
``_verify_fast_batched``), with ``attn_impl="kernel"`` so that every draft
prefill runs the flash-attention route.

Asserted: the slice as a whole emits the JAX engine's ``serve_all`` tokens;
every decode x offload combination (all five policies) emits the port's
greedy tokens under concurrency; batched rounds give each session the tokens of
serving it alone, and on one cache snapshot its solo fast block's logits bit
for bit; a session that misses falls back alone; ≤2 host syncs and one
``cache_moe`` call per MoE layer per all-hit round; stop tokens, admission
beyond ``concurrency``, deadlines and early close; per-request metrics add
up to the cumulative counters; the plain ``cache_moe`` gives a row the same
bits alone and in a batch; the launcher's ``--concurrency``.

Reduced mixtral in f32 with the reference's weights, prompts made from a
seed with numpy."""
import dataclasses
import sys

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
from repro.models.registry import build_model as jax_build
from repro_torch.configs.registry import get_config
from repro_torch.core.engine import (DECODE_POLICIES, RUNTIME_COUNTER_KEYS,
                                     Engine, EngineConfig, Request,
                                     derive_draft_config)
from repro_torch.core.sd import greedy_generate
from repro_torch.kernels import ref as R
from repro_torch.launch import serve as launcher
from repro_torch.models.convert import load_jax_params
from repro_torch.models.registry import build_model

torch.set_num_threads(1)  # pytest -n: several processes share the cores

TOK = 10
PLENS = (4, 6, 9)            # ragged prompts, hence ragged prefill blocks


@pytest.fixture(scope="module")
def ms():
    jcfg = dataclasses.replace(jax_config("mixtral-8x7b").reduced(
        dtype="float32"), attn_impl="kernel")
    cfg = dataclasses.replace(get_config("mixtral-8x7b").reduced(
        dtype="float32"), attn_impl="kernel")
    jtp = jax_build(jcfg).init(jax.random.PRNGKey(0))
    jdp = jax_build(jax_derive(jcfg)).init(jax.random.PRNGKey(1))
    dcfg = derive_draft_config(cfg)
    target = load_jax_params(build_model(cfg, "cpu"),
                             jax.tree.map(np.asarray, jtp))
    draft = load_jax_params(build_model(dcfg, "cpu"),
                            jax.tree.map(np.asarray, jdp))
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, cfg.vocab_size, (1, n)) for n in PLENS]
    refs = [greedy_generate(target, torch.from_numpy(p), TOK, 64).tolist()
            for p in prompts]
    return dict(jcfg=jcfg, jtp=jtp, jdp=jdp, cfg=cfg, dcfg=dcfg,
                target=target, draft=draft, prompts=prompts, refs=refs)


def _engine(ms, decode="sd", offload="spmoe", slots=None, **over):
    if slots is None:                        # ample: every expert fits
        slots = ms["cfg"].num_moe_layers * ms["cfg"].num_experts
    over.setdefault("draft_len", 3)
    over.setdefault("max_seq", 64)
    return Engine(EngineConfig(model=ms["cfg"], draft=ms["dcfg"],
                               decode=decode, offload=offload,
                               cache_slots=slots, **over),
                  ms["target"], ms["draft"])


def _reqs(prompts, n=TOK, **kw):
    return [Request(prompt=p, max_new_tokens=n, request_id=f"r{i}", **kw)
            for i, p in enumerate(prompts)]


def _warm(eng, ms):
    """Serve once, then load every expert the serve did not: all later
    rounds are all-hit fused rounds."""
    rt = eng.runtime
    eng.serve_all(_reqs(ms["prompts"][:2]), concurrency=2)
    assert rt.prefetcher.drain(timeout=30)
    every = [(l, e) for l in range(rt.store.num_layers)
             for e in range(rt.store.num_experts)]
    missing = [k for k in every if not rt.cache.contains(k)]
    if missing:
        rt.cache.insert(missing, rt.store.fetch(missing))


def test_serve_all_matches_jax_serve_all(ms):
    """The slice as a whole: three ragged requests, two at a time, sd x
    spmoe, flash-attention draft prefill, synchronous prefetch on both
    sides."""
    common = dict(decode="sd", offload="spmoe", cache_slots=8, draft_len=3,
                  max_seq=64, prefetch_mode="vanilla")
    jcfg = ms["jcfg"]
    with JaxEngine(JaxEngineConfig(model=jcfg, draft=jax_derive(jcfg),
                                   **common), ms["jtp"], ms["jdp"]) as jeng:
        want = jeng.serve_all([JaxRequest(prompt=jnp.asarray(p),
                                          max_new_tokens=TOK)
                               for p in ms["prompts"]], concurrency=2)
    with Engine(EngineConfig(model=ms["cfg"], draft=ms["dcfg"], **common),
                ms["target"], ms["draft"]) as eng:
        got = eng.serve_all(_reqs(ms["prompts"]), concurrency=2)
    for g, w, ref in zip(got, want, ms["refs"]):
        assert g.tokens == w.tokens
        assert g.tokens == ref


@pytest.mark.parametrize("offload", ["none", "spmoe", "on-demand",
                                     "adapmoe", "moe-infinity"])
@pytest.mark.parametrize("decode", DECODE_POLICIES)
def test_serve_all_emits_the_ports_greedy(ms, decode, offload):
    """A tight cache keeps the offload policies under miss and eviction
    pressure, so rounds mix fused commits with solo fallbacks."""
    with _engine(ms, decode=decode, offload=offload, slots=8,
                 max_draft_len=5) as eng:
        res = eng.serve_all(_reqs(ms["prompts"]), concurrency=2)
    for r, ref in zip(res, ms["refs"]):
        assert r.tokens == ref, (decode, offload)
        assert r.finish_reason == "length"
        assert r.metrics.tokens == TOK


def test_batched_rounds_give_each_session_its_solo_tokens(ms):
    """Three sessions at once (sd-adaptive, each with its own draft-length
    controller) emit what each emits served alone, and the fused path
    really ran.  Ragged blocks in one fused round are held to the solo
    blocks bit for bit in test_fused_round_logits_equal_solo_fast_blocks."""
    kw = dict(decode="sd-adaptive", min_draft_len=1, max_draft_len=5)
    with _engine(ms, **kw) as eng:
        solo = [eng.submit(r) for r in _reqs(ms["prompts"])]
    with _engine(ms, **kw) as eng:
        rt = eng.runtime
        sizes = []
        orig = rt._verify_fast_batched

        def spy(tokens, *a):
            sizes.append([t.shape[1] for t in tokens])
            return orig(tokens, *a)

        rt._verify_fast_batched = spy
        res = eng.serve_all(_reqs(ms["prompts"]), concurrency=3)
    assert sizes and max(len(s) for s in sizes) == 3, sizes
    for r, s, ref in zip(res, solo, ms["refs"]):
        assert r.tokens == s.tokens == ref


def test_fused_round_logits_equal_solo_fast_blocks(ms):
    """On one cache snapshot, each session's logits (and all-hit flag,
    history, activation count) from the fast round's body (``_fast_body``
    over every session) equal its solo block's bit for bit."""
    with _engine(ms) as eng:
        rt = eng.runtime
        _warm(eng, ms)
        sts = [rt.start_session(torch.from_numpy(p), 8)
               for p in ms["prompts"]]
        rng = np.random.default_rng(3)
        blocks = [torch.cat([st.cur, torch.from_numpy(
            rng.integers(0, ms["cfg"].vocab_size, (1, n)))], dim=1)
            for st, n in zip(sts, (3, 1, 4))]

        def caches():
            return [{"layers": [{n: t.clone() for n, t in c.items()}
                                for c in st.tcache["layers"]]} for st in sts]

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


def test_missing_session_falls_back_alone(ms):
    """Force session 1's all-hit flag False in every fused round: it
    re-verifies alone on the slow path (still lossless) while session 0
    keeps committing fused fast blocks without a fallback."""
    with _engine(ms) as eng:
        rt = eng.runtime
        _warm(eng, ms)
        forced = []
        orig = rt._verify_fast_batched

        def force_miss(*args):
            logits, ok, hists, nact = orig(*args)
            if ok.shape[0] >= 2:
                ok = ok.clone()
                ok[1] = False
                forced.append(1)
            return logits, ok, hists, nact

        rt._verify_fast_batched = force_miss
        res = eng.serve_all(_reqs(ms["prompts"][:2]), concurrency=2)
    assert forced, "no fused round ran on the warm engine"
    for r, ref in zip(res, ms["refs"]):
        assert r.tokens == ref
    assert res[1].metrics.fast_fallbacks >= 1
    assert res[0].metrics.fast_fallbacks == 0
    assert res[0].metrics.fast_blocks >= 1


def test_all_hit_round_syncs_twice_and_fuses_one_call_per_layer(ms):
    """Warm, every expert cached: each fused round syncs with the host at
    most twice for all its sessions, calls ``cache_moe`` once per MoE
    layer, and counts as one launch of its round."""
    with _engine(ms) as eng:
        rt = eng.runtime
        _warm(eng, ms)
        moe_calls = []
        orig_moe, orig_fused = rt._moe_apply, rt._round_fused

        def count_moe(*a):
            moe_calls.append(1)
            return orig_moe(*a)

        per_round = []

        def spy_fused(fused, *a):
            m0, s0, f0 = len(moe_calls), rt.host_syncs, rt.fast_blocks
            orig_fused(fused, *a)
            per_round.append((len(fused), len(moe_calls) - m0,
                              rt.host_syncs - s0, rt.fast_blocks - f0))

        rt._moe_apply, rt._round_fused = count_moe, spy_fused
        r0, l0, f0 = rt.verify_rounds, rt.round_launches, rt.fast_fallbacks
        res = eng.serve_all(_reqs(ms["prompts"][:2]), concurrency=2)
        rounds = rt.verify_rounds - r0
        launches = rt.round_launches - l0
        assert rt.fast_fallbacks == f0
    for r, ref in zip(res, ms["refs"]):
        assert r.tokens == ref
    assert per_round, "no fused round ran"
    L = ms["cfg"].num_moe_layers
    for n, moe, syncs, fast in per_round:
        assert (n, moe, syncs, fast) == (2, L, 2, 2)
    assert 0 < rounds == launches


def test_stop_tokens_and_admission_beyond_concurrency(ms):
    """Four requests, two at a time: the third is admitted only once one
    of the first two finished (request 0 ends at its stop token), and no
    round ever holds more than two sessions."""
    prompts = ms["prompts"] + [ms["prompts"][0]]
    refs = ms["refs"] + [ms["refs"][0]]
    stop = refs[0][3]
    with _engine(ms, slots=8) as eng:
        rt = eng.runtime
        widths = []
        orig = rt.session_turns

        def spy(sts):
            widths.append(len(sts))
            return orig(sts)

        rt.session_turns = spy
        reqs = _reqs(prompts)
        reqs[0] = Request(prompt=prompts[0], max_new_tokens=TOK,
                          stop_tokens=(stop,), request_id="r0")
        order = list(eng.serve(reqs, concurrency=2))
        res = eng.last_batch
    assert max(widths) <= 2
    cut = refs[0].index(stop) + 1
    assert res[0].finish_reason == "stop"
    assert res[0].tokens == refs[0][:cut]
    for r, ref in zip(res[1:], refs[1:]):
        assert r.finish_reason == "length" and r.tokens == ref
    names = [n for n, _ in order]
    first_late = min(names.index("r2"), names.index("r3"))
    done_early = min(len(names) - names[::-1].index(n) - 1
                     for n in ("r0", "r1"))
    assert first_late > done_early
    for name, r in zip(("r0", "r1", "r2", "r3"), res):
        assert [t for n, t in order if n == name] == r.tokens


def test_per_request_metrics_add_up_to_cumulative_counters(ms):
    with _engine(ms, slots=8, prefetch_mode="vanilla") as eng:
        res = eng.serve_all(_reqs(ms["prompts"]), concurrency=2)
        counters = eng.runtime.counters()
        cum = eng.metrics()
    assert cum.requests == 3 and cum.tokens == 3 * TOK
    for k in ("lookups", "hits", "on_demand_loads", "host_syncs",
              "verify_blocks", "fast_blocks", "fast_fallbacks",
              "iterations", "drafted", "accepted"):
        assert sum(r.metrics[k] for r in res) == cum[k] == counters[k], k
    for k in RUNTIME_COUNTER_KEYS:
        assert sum(r.metrics[k] for r in res) == cum[k], k
    assert cum.verify_blocks > 0 and cum.host_syncs > 0


def test_deadline_and_early_close(ms):
    """An expired request is retired by the round's deadline sweep without
    disturbing its batchmate; closing the serve iterator early aborts the
    unfinished sessions and leaves the engine reusable."""
    with _engine(ms) as eng:
        reqs = _reqs(ms["prompts"][:2])
        reqs[0] = Request(prompt=ms["prompts"][0], max_new_tokens=TOK,
                          deadline_s=0.0, request_id="r0")
        res = eng.serve_all(reqs, concurrency=2)
        assert res[0].finish_reason == "deadline"
        assert res[0].tokens == ms["refs"][0][:len(res[0].tokens)]
        assert res[1].tokens == ms["refs"][1]
        it = eng.serve(_reqs(ms["prompts"]), concurrency=2)
        next(it)
        it.close()
        assert [r.finish_reason for r in eng.last_batch] == ["aborted"] * 3
        again = eng.serve_all(_reqs(ms["prompts"][:1]), concurrency=2)
    assert again[0].tokens == ms["refs"][0]


def test_cache_moe_ref_row_alone_equals_row_in_batch():
    """The plain version's bits for a row do not depend on its batchmates
    (what lets CPU batched rounds equal solo blocks bit for bit)."""
    rng = np.random.default_rng(8)
    T, k, S, d, f = 13, 2, 6, 64, 128
    x = torch.from_numpy(rng.standard_normal((T, d)).astype(np.float32))
    wg, wu = [torch.from_numpy((rng.standard_normal((S, d, f)) * 0.1)
                               .astype(np.float32)) for _ in range(2)]
    wd = torch.from_numpy((rng.standard_normal((S, f, d)) * 0.1)
                          .astype(np.float32))
    si = torch.from_numpy(rng.integers(-1, S, (T, k)).astype(np.int32))
    w = torch.from_numpy(rng.uniform(size=(T, k)).astype(np.float32))
    full = R.cache_moe_ref(x, si, w, wu, wd, wg)
    for t in range(T):
        one = R.cache_moe_ref(x[t:t + 1], si[t:t + 1], w[t:t + 1], wu, wd,
                              wg)
        assert torch.equal(one, full[t:t + 1])
    part = R.cache_moe_ref(x[4:9], si[4:9], w[4:9], wu, wd, wg)
    assert torch.equal(part, full[4:9])


def test_launcher_concurrency_streams_request_token_pairs(capsys,
                                                          monkeypatch):
    monkeypatch.setattr(sys, "argv", [
        "serve", "--device", "cpu", "--requests", "3", "--concurrency", "2",
        "--tokens", "4", "--stream"])
    launcher.main()
    lines = capsys.readouterr().out.splitlines()
    pairs = [p.split(":") for p in lines[0].split()]
    assert len(pairs) == 12
    assert sorted({rid for rid, _ in pairs}) == ["req-0", "req-1", "req-2"]
    for rid in ("req-0", "req-1", "req-2"):
        assert f"[{rid}] finish=length" in lines


def test_launcher_without_concurrency_serves_one_after_another(
        capsys, monkeypatch):
    """``--concurrency 1`` (the default) goes through the same scheduler:
    each request's pairs come out whole before the next request's."""
    monkeypatch.setattr(sys, "argv", [
        "serve", "--device", "cpu", "--requests", "2", "--tokens", "4",
        "--stream"])
    launcher.main()
    lines = capsys.readouterr().out.splitlines()
    rids = [p.split(":")[0] for p in lines[0].split()]
    assert rids == ["req-0"] * 4 + ["req-1"] * 4
    for rid in ("req-0", "req-1"):
        assert f"[{rid}] finish=length" in lines
