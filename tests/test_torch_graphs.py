"""PyTorch port, captured decode steps (``core/graphs.py``): the port of
the reference's compiled steps, on the CPU, where a captured step is its
body run on static buffers.

* ``pos_dev`` (the position as a device tensor) gives the int path's
  results bit for bit: ``attention_decode`` (a wrapping ring with a window
  and a plain cache, both routes), ``mla_decode`` and ``decode_step``;
* the static body of each keyed step equals the eager body bit for bit,
  called twice with different inputs: the solo and the fused verify
  blocks, the draft step, the greedy step and the SD iteration;
* the verify block through the static body matches the reference's
  ``_verify_fast`` (JAX on the CPU, its plain ``cache_moe`` route) at the
  serving tests' parity tolerance, atol 1e-4 on f32 logits;
* the ports of the reference's compile counters: one build at init and
  none on the second fast block, the adaptive ladder built at init, one
  build per new fused round shape, nothing built at init without
  ``precompile``;
* a session's pool slot comes back on every finish reason; after an
  ``io_error`` the next request takes the slot and builds nothing.

Reduced mixtral-8x7b and deepseek-v2-lite-16b in f32 (2-4 layers, d 64),
inputs made from a seed with numpy."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_config
from repro.core.engine import Engine as JaxEngine
from repro.core.engine import EngineConfig as JaxEngineConfig
from repro.core.engine import derive_draft_config as jax_derive
from repro.models.registry import build_model as jax_build
from repro_torch.configs.registry import get_config
from repro_torch.core import sd as S
from repro_torch.core.chaos import ChaosConfig
from repro_torch.core.engine import (Engine, EngineConfig, Request,
                                     derive_draft_config)
from repro_torch.core.graphs import GraphSet, SessionPool
from repro_torch.models import layers as L
from repro_torch.models.convert import load_jax_params
from repro_torch.models.registry import build_model

TOK = 10
MAX_SEQ = 64
PARITY_ATOL = 1e-4


@pytest.fixture(scope="module")
def ms():
    jcfg = jax_config("mixtral-8x7b").reduced(dtype="float32")
    jdcfg = jax_derive(jcfg)
    cfg = get_config("mixtral-8x7b").reduced(dtype="float32")
    dcfg = derive_draft_config(cfg)
    jtp = jax_build(jcfg).init(jax.random.PRNGKey(0))
    jdp = jax_build(jdcfg).init(jax.random.PRNGKey(1))
    target = load_jax_params(build_model(cfg, "cpu"),
                             jax.tree.map(np.asarray, jtp))
    draft = load_jax_params(build_model(dcfg, "cpu"),
                            jax.tree.map(np.asarray, jdp))
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, (1, n)) for n in (6, 9)]
    return dict(jcfg=jcfg, jdcfg=jdcfg, jtp=jtp, jdp=jdp, cfg=cfg,
                dcfg=dcfg, target=target, draft=draft, prompts=prompts)


def _engine(ms, decode="sd", offload="spmoe", slots=None, **over):
    over.setdefault("draft_len", 3)
    over.setdefault("max_seq", MAX_SEQ)
    if slots is None:                  # ample: every expert fits
        slots = ms["cfg"].num_moe_layers * ms["cfg"].num_experts
    return Engine(EngineConfig(model=ms["cfg"], draft=ms["dcfg"],
                               decode=decode, offload=offload,
                               cache_slots=slots, **over),
                  ms["target"], ms["draft"])


def _preload(rt):
    every = [(l, e) for l in range(rt.store.num_layers)
             for e in range(rt.store.num_experts)]
    missing = [k for k in every if not rt.cache.contains(k)]
    if missing:
        rt.cache.insert(missing, rt.store.fetch(missing))


def _clone(tree):
    """A deep copy of a cache (dicts, lists, tensors, host ints)."""
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def _equal(a, b):
    """Bit-equal trees of tensors (and host values)."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b)
    else:
        assert a == b


def _tokens(rng, cfg, n):
    return torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, n)))


# ---------------------------------------------------------------------------
# the position as a device tensor
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["xla", "kernel"])
@pytest.mark.parametrize("arch", ["mixtral-8x7b", "llama3.2-3b"])
def test_pos_dev_attention_decode_is_bit_equal(arch, impl):
    """mixtral's reduced window (16) makes a ring of 32 slots that the
    steps below wrap; llama has no window.  Under ``"kernel"`` the one-token
    steps before the window take the flash-decode route (its plain version
    here), the rest the masked route."""
    cfg = dataclasses.replace(get_config(arch).reduced(dtype="float32"),
                              attn_impl=impl)
    model = build_model(cfg, "cpu", seed=4)
    p = model.layers[0].attn
    rng = np.random.default_rng(5)
    cache = L.init_kv_cache(cfg, 1, MAX_SEQ, torch.float32, "cpu")
    pos = 0
    for sq in (6, 1, 1, 3, 1, 4, 1) * 3:
        x = torch.from_numpy(rng.standard_normal(
            (1, sq, cfg.d_model)).astype(np.float32))
        c_int, c_dev = _clone(cache), _clone(cache)
        want, _ = L.attention_decode(p, x, c_int, pos, cfg, contiguous=True)
        got, _ = L.attention_decode(
            p, x, c_dev, pos, cfg, contiguous=True,
            pos_dev=torch.tensor(pos, dtype=torch.int32))
        assert torch.equal(got, want), (pos, sq)
        _equal(c_dev, c_int)
        cache, pos = c_int, pos + sq
    assert pos > 32                     # the mixtral ring wrapped


@pytest.mark.parametrize("sq", [1, 4])
def test_pos_dev_mla_decode_is_bit_equal(sq):
    cfg = get_config("deepseek-v2-lite-16b").reduced(dtype="float32")
    model = build_model(cfg, "cpu", seed=6)
    p = model.layers[0].attn
    rng = np.random.default_rng(7)
    cache = L.init_mla_cache(cfg, 1, 24, torch.float32, "cpu")
    for pos in range(0, 24 - sq + 1, sq):
        x = torch.from_numpy(rng.standard_normal(
            (1, sq, cfg.d_model)).astype(np.float32))
        c_dev = _clone(cache)
        want, _ = L.mla_decode(p, x, cache, pos, cfg)
        got, _ = L.mla_decode(p, x, c_dev, pos, cfg,
                              pos_dev=torch.tensor(pos, dtype=torch.int32))
        assert torch.equal(got, want)
        _equal(c_dev, cache)
    with pytest.raises(ValueError, match="does not fit"):
        L.mla_decode(p, x, cache, 24 - sq + 1, cfg,
                     pos_dev=torch.tensor(0, dtype=torch.int32))


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "deepseek-v2-lite-16b"])
def test_pos_dev_decode_step_is_bit_equal(arch):
    cfg = dataclasses.replace(get_config(arch).reduced(dtype="float32"),
                              attn_impl="kernel")
    model = build_model(cfg, "cpu", seed=8)
    rng = np.random.default_rng(9)
    _, cache = model.prefill(_tokens(rng, cfg, 5), MAX_SEQ)
    pos = 5
    for sq in (1, 4, 1, 1):
        tok = _tokens(rng, cfg, sq)
        c_dev = _clone(cache)
        want, _, wt = model.decode_step(cache, tok, pos, collect_taps=True)
        got, _, gt = model.decode_step(
            c_dev, tok, pos, collect_taps=True,
            pos_dev=torch.tensor(pos, dtype=torch.int32))
        assert torch.equal(got, want)
        _equal(gt, wt)
        _equal(c_dev, cache)
        pos += sq


# ---------------------------------------------------------------------------
# static bodies against the eager ones
# ---------------------------------------------------------------------------

def test_graph_set_static_body_and_counts():
    """``run`` copies the inputs into the static buffers and calls the body
    on them; builds are counted per kind, once per key."""
    gs = GraphSet(torch.device("cpu"))
    seen = []

    def body(x, p):
        seen.append((x, p))
        return x * p

    a = gs.run(("k", 0), body, torch.tensor([1, 2]), 3)
    b = gs.run(("k", 0), body, torch.tensor([4, 5]), 6)
    assert a.tolist() == [3, 6] and b.tolist() == [24, 30]
    assert seen[0][0] is seen[1][0] and seen[0][1].dtype == torch.int32
    assert gs.builds == {"k": 1} and gs.runs == {"k": 2}
    gs.run(("k", 1), body, torch.tensor([1, 1]), 1)
    assert gs.builds == {"k": 2}
    with pytest.raises(ValueError):
        gs.build(("k", 1), body, [torch.tensor([1]), 1])


def test_solo_verify_block_static_body_equals_eager(ms):
    with _engine(ms) as eng:
        rt = eng.runtime
        _preload(rt)
        st = rt.start_session(torch.from_numpy(ms["prompts"][0]), 8)
        rng = np.random.default_rng(10)
        T = rt._ladder()[0]
        for i in range(2):
            block = _tokens(rng, ms["cfg"], T)
            pos = st.pos + i
            tc, hist = _clone(st.tcache), st.history_dev.clone()
            want = rt._fast_body([block], [pos], [tc], [hist])
            runs = rt.graphs.runs["fast"]
            lg, ok, nh, na = rt._verify_fast(block, pos, st.slot)
            assert rt.graphs.runs["fast"] == runs + 1
            assert bool(ok)
            _equal([lg, ok.reshape(1), nh, na.reshape(1)],
                   [want[0][0], want[1], want[2][0], want[3]])
            _equal(st.tcache, tc)
        rt.finish_session(st)


def test_fused_verify_round_static_body_equals_eager(ms):
    """Run twice with new inputs, the second time with the sessions listed
    in the other order: one key (the step takes them in slot order), and
    the outputs in the round's order equal the eager body's."""
    with _engine(ms) as eng:
        rt = eng.runtime
        _preload(rt)
        both = [rt.start_session(torch.from_numpy(p), 8)
                for p in ms["prompts"]]
        assert [st.slot.index for st in both] == [0, 1]
        rng = np.random.default_rng(11)
        for i, sts in enumerate((both, both[::-1])):
            blocks = [_tokens(rng, ms["cfg"], T)
                      for T in ((4, 2) if i == 0 else (2, 4))]
            pos = [st.pos + i for st in sts]
            tcs = [_clone(st.tcache) for st in sts]
            hists = [st.history_dev.clone() for st in sts]
            want = rt._fast_body(blocks, pos, tcs, hists)
            got = rt._verify_fast_batched(blocks, pos,
                                          [st.slot for st in sts])
            assert bool(got[1].all())
            _equal(list(got), list(want))
            _equal([st.tcache for st in sts], tcs)
        assert rt.graphs.builds["fused"] == 1
        assert rt.graphs.runs["fused"] == 2
        sts = both
        for st in sts:
            rt.finish_session(st)


def test_draft_step_static_body_equals_eager(ms):
    with _engine(ms) as eng:
        rt = eng.runtime
        st = rt.start_session(torch.from_numpy(ms["prompts"][1]), 8)
        rng = np.random.default_rng(12)
        for i in range(3):
            tok = _tokens(rng, ms["cfg"], 1)
            pos = st.pos + i
            dc = _clone(st.dcache)
            lg, _, taps = rt.draft.decode_step(dc, tok, pos,
                                               collect_taps=True)
            nxt, gtaps = rt._draft_step(st, tok, pos)
            assert torch.equal(nxt, torch.argmax(lg[:, -1], -1)[:, None])
            _equal(gtaps, taps)
            _equal(st.dcache, dc)
        assert rt.graphs.runs["draft"] == 3
        rt.finish_session(st)


def _pool(model, draft=None):
    return SessionPool(model, draft, MAX_SEQ)


@pytest.mark.parametrize("attn_impl", ["xla", "kernel"])
def test_greedy_step_static_body_equals_eager(ms, attn_impl):
    cfg = dataclasses.replace(ms["dcfg"], attn_impl=attn_impl)
    model = load_jax_params(build_model(cfg, "cpu"),
                            jax.tree.map(np.asarray, ms["jdp"]))
    gs = GraphSet(torch.device("cpu"))
    slot = _pool(model).take()
    rng = np.random.default_rng(13)
    _, cache = model.prefill(_tokens(rng, cfg, 5), MAX_SEQ,
                             cache=slot.tcache)
    step = S.make_greedy_step(model, gs)
    eager = S.make_greedy_step(model)
    for pos in (5, 6):
        tok = _tokens(rng, cfg, 1)
        ref = _clone(cache)
        want = eager(ref, tok, pos)
        got = step(cache, tok, pos, slot)
        assert torch.equal(got, want)
        _equal(cache, ref)
    assert gs.builds == {"greedy": 1} and gs.runs == {"greedy": 2}


def test_sd_iteration_static_body_equals_eager(ms):
    target, draft = ms["target"], ms["draft"]
    gs = GraphSet(torch.device("cpu"))
    slot = _pool(target, draft).take()
    prompt = torch.from_numpy(ms["prompts"][0])
    _, tcache = target.prefill(prompt, MAX_SEQ, cache=slot.tcache)
    _, dcache = draft.prefill(prompt, MAX_SEQ, cache=slot.dcache)
    step = S.make_sd_step(draft, target, 3, gs)
    eager = S.make_sd_step(draft, target, 3)
    rng = np.random.default_rng(14)
    pos = prompt.shape[1]
    for _ in range(2):
        cur = _tokens(rng, ms["cfg"], 1)
        tc, dc = _clone(tcache), _clone(dcache)
        want = eager(dc, tc, cur, pos)
        got = step(dcache, tcache, cur, pos, slot)
        assert got.tokens == want.tokens
        assert got.n_accepted == want.n_accepted and got.pos == want.pos
        assert torch.equal(got.cur, want.cur)
        _equal(tcache, tc)
        _equal(dcache, dc)
        pos = got.pos
    assert gs.builds == {"sd": 1} and gs.runs == {"sd": 2}


@pytest.mark.parametrize("decode", ["greedy", "sd", "sd-adaptive"])
def test_offload_none_streams_through_static_steps(ms, decode):
    """An engine without an offload plane serves through its pool and its
    captured steps, emits what the eager streams emit, and a second
    request of the same shape builds nothing."""
    with _engine(ms, decode=decode, offload="none",
                 max_draft_len=4) as eng:
        first = eng.submit(Request(prompt=ms["prompts"][0],
                                   max_new_tokens=TOK))
        builds = dict(eng.graphs.builds)
        second = eng.submit(Request(prompt=ms["prompts"][0],
                                    max_new_tokens=TOK))
        assert dict(eng.graphs.builds) == builds
        assert sum(eng.graphs.runs.values()) > 0
        assert len(eng._pool.slots) == 1 and eng._pool.in_use == 0
    ref = S.greedy_generate(ms["target"], torch.from_numpy(
        ms["prompts"][0]), TOK, MAX_SEQ).tolist()
    assert first.tokens == second.tokens == ref


# ---------------------------------------------------------------------------
# the static verify block against the reference's _verify_fast
# ---------------------------------------------------------------------------

def test_static_verify_block_matches_reference_verify_fast(ms):
    """Both engines offload on demand: no prefetch worker moves the caches
    while the prefill and the block run (the verify block itself is the
    same under every offload policy)."""
    config = JaxEngineConfig(model=ms["jcfg"], draft=ms["jdcfg"],
                             decode="sd", offload="on-demand", draft_len=3,
                             max_seq=MAX_SEQ, prefetch_mode="vanilla",
                             cache_slots=ms["cfg"].num_moe_layers *
                             ms["cfg"].num_experts)
    prompt = ms["prompts"][1]
    block = np.random.default_rng(15).integers(0, ms["cfg"].vocab_size,
                                               (1, 4))
    with JaxEngine(config, ms["jtp"], ms["jdp"]) as jeng:
        jrt = jeng.runtime
        for l in range(jrt.store.num_layers):
            keys = [(l, e) for e in range(jrt.store.num_experts)]
            jrt.cache.insert(keys, jrt.store.fetch(keys))
        jst = jrt.start_session(jnp.asarray(prompt), 8)
        bufs, table = jrt.cache.snapshot()
        jl, jok, _, jh, jn = jrt._verify_fast(
            bufs, table, jst.history_dev, jnp.asarray(block, jnp.int32),
            jst.pos, jst.tcache)
    with _engine(ms, offload="on-demand", prefetch_mode="vanilla") as eng:
        rt = eng.runtime
        _preload(rt)
        st = rt.start_session(torch.from_numpy(prompt), 8)
        lg, ok, nh, na = rt._verify_fast(torch.from_numpy(block), st.pos,
                                         st.slot)
        assert rt.graphs.runs["fast"] >= 1
        rt.finish_session(st)
    assert bool(jok) and bool(ok)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jl),
                               atol=PARITY_ATOL, rtol=0)
    np.testing.assert_array_equal(nh.numpy(), np.asarray(jh))
    assert float(na) == float(jn)


# ---------------------------------------------------------------------------
# the reference's compile counters
# ---------------------------------------------------------------------------

def test_no_rebuild_on_second_fast_block(ms):
    """tests/test_engine.py::test_no_retrace_on_second_fast_block: init
    builds the fast step of the block length; the armed fast blocks reuse
    it."""
    with _engine(ms) as eng:
        rt = eng.runtime
        assert rt.graphs.builds["fast"] == 1, "init built no fast step"
        res = eng.submit(Request(prompt=ms["prompts"][0],
                                 max_new_tokens=12))
        assert res.metrics.fast_blocks >= 2, "fast path never engaged"
        assert rt.graphs.builds["fast"] == 1, "a fast block rebuilt"
        assert rt.graphs.runs["fast"] >= res.metrics.fast_blocks \
            - rt.eager_fast_blocks
    ref = S.greedy_generate(ms["target"], torch.from_numpy(
        ms["prompts"][0]), 12, MAX_SEQ).tolist()
    assert res.tokens == ref


def test_adaptive_ladder_built_at_init(ms):
    """tests/test_sessions.py::test_adaptive_ladder_precompiled."""
    with _engine(ms, decode="sd-adaptive", min_draft_len=1,
                 max_draft_len=3) as eng:
        rt = eng.runtime
        assert rt._ladder() == (2, 3, 4)
        assert rt.graphs.builds["fast"] == 3, "ladder not built at init"
        keys = {k for k in rt.graphs.pool_bytes() if k[0] == "fast"}
        assert {k[1][:2] for k in keys} == {(0, 2), (0, 3), (0, 4)}
        res = eng.submit(Request(prompt=ms["prompts"][0],
                                 max_new_tokens=TOK))
        assert res.metrics.fast_blocks >= 1, "fast path never engaged"
        assert rt.graphs.builds["fast"] == 3, "an adapted length rebuilt"


def test_one_build_per_new_fused_round_shape(ms):
    """tests/test_batched_verify.py:193-198: a round shape builds once; the
    same shape again builds nothing.  The port keys a round by each
    session's (slot, T) in slot order, so the same lengths over the same
    slots with the sessions listed in the other order build nothing, while
    a permutation of the lengths over the two slots is a new shape (its
    caches differ)."""
    with _engine(ms) as eng:
        rt = eng.runtime
        eng.serve_all([Request(prompt=p, max_new_tokens=TOK)
                       for p in ms["prompts"]], concurrency=2)
        _preload(rt)
        sts = [rt.start_session(torch.from_numpy(p), 12)
               for p in ms["prompts"]]
        rt.session_turns(sts)               # deliver the prefill chunks
        assert all(st.fast_ok for st in sts)
        for lens, flip, new in (((2, 4), False, 1), ((2, 4), False, 0),
                                ((4, 2), False, 1), ((2, 4), False, 0),
                                ((2, 4), True, 0)):
            b0 = rt.graphs.builds["fused"]
            r0 = rt.graphs.runs["fused"]
            sts[0].n, sts[1].n = lens
            rt.session_turns(sts[::-1] if flip else sts)
            assert rt.graphs.runs["fused"] == r0 + 1
            assert rt.graphs.builds["fused"] - b0 == new, lens
        for st in sts:
            rt.finish_session(st)


def test_nothing_built_at_init_without_precompile(ms):
    with _engine(ms, precompile=False) as eng:
        rt = eng.runtime
        assert sum(rt.graphs.builds.values()) == 0
        res = eng.submit(Request(prompt=ms["prompts"][0],
                                 max_new_tokens=12))
        assert res.metrics.fast_blocks >= 1
        assert rt.graphs.builds["fast"] == 1     # built on first use
        assert rt.graphs.builds["draft"] >= 1


# ---------------------------------------------------------------------------
# the pool slot comes back on every end of a session
# ---------------------------------------------------------------------------

def _end(eng, ms, reason):
    """Serve one request that ends with ``reason``; returns its result."""
    prompt = ms["prompts"][0]
    if reason == "length":
        return eng.submit(Request(prompt=prompt, max_new_tokens=4))
    if reason == "stop":
        first = eng.submit(Request(prompt=prompt, max_new_tokens=1))
        return eng.submit(Request(prompt=prompt, max_new_tokens=TOK,
                                  stop_tokens=first.tokens))
    if reason == "aborted":
        it = eng.stream(Request(prompt=prompt, max_new_tokens=TOK))
        next(it)
        it.close()
        return eng.last_result
    if reason == "deadline":
        return eng.serve_all([Request(prompt=prompt, max_new_tokens=TOK,
                                      deadline_s=1e-6)])[0]
    if reason == "cancelled":
        from repro_torch.core.engine import Session
        s = Session(eng, Request(prompt=prompt, max_new_tokens=TOK))
        s.turn()
        s.cancel()
        return s.result
    raise ValueError(reason)


@pytest.mark.parametrize("offload", ["spmoe", "none"])
@pytest.mark.parametrize("reason", ["length", "stop", "aborted",
                                    "deadline", "cancelled"])
def test_pool_slot_comes_back_on_every_finish_reason(ms, offload, reason):
    with _engine(ms, offload=offload) as eng:
        pool = eng.runtime.pool if eng.runtime is not None else eng._pool
        res = _end(eng, ms, reason)
        assert res.finish_reason == reason
        assert pool.in_use == 0
        again = eng.submit(Request(prompt=ms["prompts"][1],
                                   max_new_tokens=4))
        assert again.finish_reason == "length"
        assert pool.in_use == 0 and len(pool.slots) == 1


def test_io_error_gives_the_slot_back_and_builds_nothing(ms):
    """Chaos on (checksummed fetches, injected fetch errors the retries
    absorb) and a host store that then fails for real: the session ends
    with ``io_error``; the next request takes its slot, slot 0, and
    builds no step."""
    chaos = ChaosConfig(seed=3, fetch_error_rate=0.3)
    with _engine(ms, slots=8, chaos=chaos, io_retries=1) as eng:
        rt = eng.runtime
        warm = eng.submit(Request(prompt=ms["prompts"][0],
                                  max_new_tokens=TOK))
        assert warm.finish_reason == "length"
        builds = dict(rt.graphs.builds)
        orig = rt.store.fetch_verified

        def down(keys):
            raise OSError("host store unreachable")

        rt.store.fetch_verified = down
        failed = eng.submit(Request(prompt=ms["prompts"][1],
                                    max_new_tokens=TOK))
        rt.store.fetch_verified = orig
        assert failed.finish_reason == "io_error"
        assert rt.pool.in_use == 0
        nxt = eng.submit(Request(prompt=ms["prompts"][0],
                                 max_new_tokens=TOK))
        assert nxt.finish_reason == "length"
        assert nxt.tokens == warm.tokens
        assert len(rt.pool.slots) == 1 and rt.pool.in_use == 0
        assert dict(rt.graphs.builds) == builds
