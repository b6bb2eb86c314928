"""PyTorch port, the serving drills of tests/test_chaos.py on the port's
engine, on the CPU: the fault-injected I/O plane, the supervised prefetch
worker, and the graceful-degradation ladder.

The acceptance contract mirrors the paper's losslessness guarantee under a
hostile I/O plane: with seeded fault injection (transient fetch/insert
errors, latency spikes, staged-payload corruption, worker kills) every
decode x offload combination commits the port's fault-free greedy stream
(the lossless sweep is in tests/test_torch_chaos_sweep.py).  Here: the
injector, retry-with-backoff, per-task deadlines, checksum
quarantine-and-refetch, supervised worker restart, bounded drains and
error rings, the degradation ladder's on-demand rung and its recovery, the
per-request ``io_error`` rung (real faults only), and per-request
deadlines.

Reduced mixtral in f32 with the reference's weights (through
``params_from_jax``), the fixture of tests/test_torch_engine.py; prompts
made from a seed with numpy."""
import threading
import time

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_config
from repro.core.engine import derive_draft_config as jax_derive
from repro.models.registry import build_model as jax_build
from repro_torch.configs.registry import get_config
from repro_torch.core.cache import ExpertCache
from repro_torch.core.chaos import ChaosConfig, ChaosError, ChaosInjector
from repro_torch.core.engine import (Engine, EngineConfig, Request,
                                     derive_draft_config)
from repro_torch.core.offload import HostExpertStore
from repro_torch.core.prefetcher import Prefetcher
from repro_torch.core.sd import greedy_generate
from repro_torch.models.convert import load_jax_params
from repro_torch.models.registry import build_model

torch.set_num_threads(1)  # pytest -n: several processes share the cores

TOK = 10


@pytest.fixture(scope="module")
def ms():
    """Reduced-mixtral target / draft on the reference's weights, two
    prompts, their greedy references."""
    jcfg = jax_config("mixtral-8x7b").reduced(dtype="float32")
    cfg = get_config("mixtral-8x7b").reduced(dtype="float32")
    dcfg = derive_draft_config(cfg)
    jtp = jax_build(jcfg).init(jax.random.PRNGKey(0))
    jdp = jax_build(jax_derive(jcfg)).init(jax.random.PRNGKey(1))
    target = load_jax_params(build_model(cfg, "cpu"),
                             jax.tree.map(np.asarray, jtp))
    draft = load_jax_params(build_model(dcfg, "cpu"),
                            jax.tree.map(np.asarray, jdp))
    prompts = [np.random.default_rng(2 + i).integers(0, cfg.vocab_size,
                                                     (1, 6))
               for i in range(2)]
    refs = [greedy_generate(target, torch.from_numpy(p), TOK, 64).tolist()
            for p in prompts]
    return cfg, dcfg, target, draft, prompts, refs


def _engine(ms, decode="sd", offload="spmoe", slots=None, **over):
    cfg, dcfg, target, draft, _, _ = ms
    if slots is None:
        slots = cfg.num_moe_layers * cfg.num_experts
    over.setdefault("draft_len", 3)
    over.setdefault("max_seq", 64)
    over.setdefault("retry_backoff_s", 0.001)
    return Engine(EngineConfig(model=cfg, draft=dcfg, decode=decode,
                               offload=offload, cache_slots=slots, **over),
                  target, draft)


def _reqs(prompts, **kw):
    return [Request(prompt=p, max_new_tokens=TOK, **kw) for p in prompts]


def _store_cache(ms, slots=8, chaos=None):
    cfg, _, target, _, _, _ = ms
    store = HostExpertStore(cfg, target, chaos=chaos)
    cache = ExpertCache(slots, store.buffer_shapes(), torch.float32,
                        table_shape=(store.num_layers, store.num_experts),
                        chaos=chaos, device="cpu")
    return store, cache


# ---------------------------------------------------------------------------
# the injector itself: deterministic, bounded, suppressible
# ---------------------------------------------------------------------------

def test_injector_deterministic_and_streak_bounded():
    """Same seed -> same fault schedule; the consecutive-hard-fault streak
    never exceeds max_consecutive_faults, so a bounded retry budget can
    always out-wait an unlucky run."""
    cfg = ChaosConfig(seed=3, fetch_error_rate=0.6, max_consecutive_faults=2)

    def schedule():
        inj = ChaosInjector(cfg)
        out = []
        for _ in range(200):
            try:
                inj.on_fetch(1)
                out.append(0)
            except ChaosError:
                out.append(1)
        return out

    a, b = schedule(), schedule()
    assert a == b and sum(a) > 0
    streak = best = 0
    for hit in a:
        streak = streak + 1 if hit else 0
        best = max(best, streak)
    assert best <= 2


def test_injector_calm_suppresses_injection_only():
    inj = ChaosInjector(ChaosConfig(seed=0, fetch_error_rate=1.0,
                                    corrupt_rate=1.0))
    with inj.calm():
        for _ in range(20):
            inj.on_fetch(1)            # must not raise
        payload = {"w": np.ones((1, 4), np.float32)}
        assert not inj.maybe_corrupt(payload)
        assert np.all(payload["w"] == 1.0)
    with pytest.raises(ChaosError):
        for _ in range(20):
            inj.on_fetch(1)


# ---------------------------------------------------------------------------
# prefetcher units: retry, deadline, restart, bounded drain, checksum
# ---------------------------------------------------------------------------

def test_prefetcher_retries_transient_faults(ms):
    """A fetch that fails twice then succeeds completes the task; the retry
    counter records the recovery and the breaker streak resets."""
    store, cache = _store_cache(ms)
    fails = {"n": 0}
    orig = store.fetch

    def flaky(keys):
        if fails["n"] < 2:
            fails["n"] += 1
            raise ChaosError("transient")
        return orig(keys)

    store.fetch = flaky
    pf = Prefetcher(store, cache, mode="worker", retries=3, backoff_s=0.001)
    try:
        task = pf.submit([(0, 0), (0, 1)])
        assert pf.wait_task(task, timeout=10.0)
        assert task.failed is None
        assert cache.contains((0, 0)) and cache.contains((0, 1))
        assert pf.retry_count == 2
        assert pf.error_count == 0
        assert pf.consecutive_failures == 0
    finally:
        pf.stop()


def test_prefetcher_task_deadline_expires_instead_of_retrying_forever(ms):
    """An always-failing task under a tiny per-task deadline fails fast
    (done set, failure recorded) instead of burning its whole retry
    budget."""
    store, cache = _store_cache(ms)

    def always_fail(keys):
        raise ChaosError("down")

    store.fetch = always_fail
    pf = Prefetcher(store, cache, mode="worker", retries=50, backoff_s=0.05,
                    task_timeout_s=0.05)
    try:
        t0 = time.perf_counter()
        task = pf.submit([(0, 0)])
        assert pf.wait_task(task, timeout=10.0)
        assert task.failed is not None
        assert pf.error_count == 1
        # 50 retries x 50ms backoff would be seconds; the deadline cut it
        assert time.perf_counter() - t0 < 2.0
    finally:
        pf.stop()


def test_prefetcher_worker_killed_restarts_and_completes(ms):
    """Chaos worker kills on every second task dequeue: each death hands
    the task back to the queue, the supervisor restarts the worker, and
    every submitted task still completes — inflight accounting never
    strands drain()."""
    chaos = ChaosInjector(ChaosConfig(seed=0, kill_worker_every=2))
    store, cache = _store_cache(ms, slots=16)
    pf = Prefetcher(store, cache, mode="worker", max_worker_restarts=50,
                    chaos=chaos)
    try:
        tasks = [pf.submit([(0, i)]) for i in range(4)]
        for t in tasks:
            assert pf.wait_task(t, timeout=30.0)
        assert pf.drain(timeout=30.0)
        assert pf.worker_deaths > 0
        assert pf.worker_restarts > 0
        assert all(t.failed is None for t in tasks)
        assert all(cache.contains((0, i)) for i in range(4))
    finally:
        pf.stop()


def test_prefetcher_drain_timeout_returns_instead_of_hanging(ms):
    """drain(timeout=) on a worker stuck inside a long transfer returns
    False promptly (drain_timeouts counted) instead of hanging the caller;
    a later unbounded drain completes once the transfer finishes."""
    store, cache = _store_cache(ms)
    release = threading.Event()
    orig = store.fetch

    def stuck(keys):
        release.wait(timeout=10.0)
        return orig(keys)

    store.fetch = stuck
    pf = Prefetcher(store, cache, mode="worker")
    try:
        pf.submit([(0, 0)])
        t0 = time.perf_counter()
        assert pf.drain(timeout=0.2) is False
        assert time.perf_counter() - t0 < 2.0
        assert pf.drain_timeouts == 1
        release.set()
        assert pf.drain(timeout=10.0)
        assert cache.contains((0, 0))
    finally:
        release.set()
        pf.stop()


def test_checksum_corruption_quarantined_and_refetched(ms):
    """A corrupted staged payload is caught by verification, NEVER inserted
    into the device cache, and the retry refetches it cleanly — the cache
    ends up holding the canonical bytes."""
    chaos = ChaosInjector(ChaosConfig(seed=0, corrupt_rate=1.0,
                                      max_consecutive_faults=1))
    store, cache = _store_cache(ms, chaos=chaos)
    pf = Prefetcher(store, cache, mode="worker", retries=3, backoff_s=0.001,
                    verify=True, chaos=chaos)
    try:
        task = pf.submit([(0, 0)])
        assert pf.wait_task(task, timeout=10.0)
        assert task.failed is None
        assert chaos.injected["corruptions"] >= 1
        assert store.checksum_failures >= 1
        assert pf.checksum_refetches >= 1
        # the slot holds the CANONICAL bytes, not the corrupted ones
        slot = cache.table[(0, 0)]
        with chaos.calm():             # calm() guarantees a clean reference
            want = store.fetch([(0, 0)])
        assert torch.equal(cache.bufs["wu"][slot], want["wu"][0])
        assert torch.equal(cache.bufs["wu"][slot], store.expert("wu", 0, 0))
    finally:
        pf.stop()


def test_stop_timed_out_join_keeps_handle_and_refuses_submits(ms):
    """stop() keeps the thread handle when the join TIMES OUT, so a
    wedged-but-alive worker cannot race a later inline submit on the same
    queue / cache: submits are refused while the zombie may still wake, and
    a later stop() finishes the job."""
    store, cache = _store_cache(ms)
    release = threading.Event()
    orig = store.fetch

    def stuck(keys):
        release.wait(timeout=10.0)
        return orig(keys)

    store.fetch = stuck
    pf = Prefetcher(store, cache, mode="worker")
    pf.submit([(0, 0)])
    time.sleep(0.05)                   # let the worker enter the fetch
    assert pf.stop(timeout=0.1) is False
    assert pf._thread is not None      # handle kept: worker still alive
    assert pf.submit([(0, 1)]) is None
    assert pf.refused_submits == 1
    release.set()
    assert pf.stop(timeout=10.0) is True
    assert pf._thread is None


def test_error_ring_is_bounded(ms):
    """Failures land in a bounded ring plus a monotonic count — no
    unbounded error-list growth on a long-running engine."""
    store, cache = _store_cache(ms)

    def always_fail(keys):
        raise ChaosError("down")

    store.fetch = always_fail
    pf = Prefetcher(store, cache, mode="vanilla", retries=0, error_ring=4)
    for i in range(12):
        pf.submit([(0, i % 8)])
    assert pf.error_count == 12
    assert len(pf.errors) == 4


# ---------------------------------------------------------------------------
# the graceful-degradation ladder
# ---------------------------------------------------------------------------

def test_ladder_degrades_to_on_demand_and_stays_lossless(ms):
    """A permanently dying worker (kill every task, zero restart budget)
    forces the ladder down to on-demand synchronous loading: serving
    completes bit-identically to the reference, degraded rounds are
    counted, and health reports the failed plane."""
    _, _, _, _, prompts, refs = ms
    chaos = ChaosConfig(seed=0, kill_worker_every=1)
    with _engine(ms, slots=8, chaos=chaos, max_worker_restarts=0) as eng:
        res = eng.serve_all(_reqs(prompts), concurrency=2)
        c = eng.runtime.counters()
        health = eng.runtime.health()
    assert [r.tokens for r in res] == refs
    assert all(r.finish_reason == "length" for r in res)
    assert c["degraded_rounds"] > 0
    assert health == "failed"


def test_ladder_recovers_when_health_returns(ms):
    """Degradation is recomputed per round, not latched: opening the
    circuit breaker by hand degrades the engine, and once the cooloff
    passes the same engine serves fast again with the prefetch plane back
    in play."""
    _, _, _, _, prompts, refs = ms
    with _engine(ms, slots=8, fail_threshold=1) as eng:
        rt = eng.runtime
        rt.prefetcher.consecutive_failures = 5     # breaker: open
        rt.prefetcher._last_failure_t = time.monotonic()
        rt._check_health()
        assert rt._degraded and rt.health() == "degraded"
        res = eng.serve_all(_reqs(prompts), concurrency=2)
        assert [r.tokens for r in res] == refs
        time.sleep(rt.prefetcher.cooloff_s + 0.05) # half-open: recover
        rt._check_health()
        assert not rt._degraded and rt.health() == "healthy"


def test_real_io_failure_finishes_request_with_io_error(ms):
    """The ladder's last rung: a REAL (non-injected) persistent I/O failure
    on the on-demand path exhausts the synchronous retry budget and ends
    the request with finish_reason="io_error" — no wrong tokens, no hang,
    and the engine survives to serve the next request."""
    _, _, _, _, prompts, refs = ms
    with _engine(ms, slots=8, io_retries=1) as eng:
        rt = eng.runtime
        orig = rt.store.fetch

        def down(keys):
            raise OSError("host store unreachable")

        rt.store.fetch = down
        res = eng.serve_all(_reqs(prompts[:1]), concurrency=1)
        assert res[0].finish_reason == "io_error"
        assert len(res[0].tokens) < TOK
        assert rt.counters()["io_errors"] > 0
        rt.store.fetch = orig                      # plane restored
        res2 = eng.serve_all(_reqs(prompts), concurrency=2)
    assert [r.tokens for r in res2] == refs
    assert all(r.finish_reason == "length" for r in res2)


def test_io_error_ends_only_the_failing_session(ms):
    """In a concurrent round, the io_error rung is per-request: the session
    whose loads fail ends with io_error while its batchmate commits its
    full reference stream.

    The reference's version warms prompt 0 on an ample cache and then fails
    every fetch; there the cold session may find every expert it needs
    cached already, never miss, and end ``"length"``.  Here the cache has 6
    slots, fewer than any prefill block touches (top-2 in each of 4 MoE
    layers: at least 8 experts), so the cold session's prefill must miss;
    and only its own loads fail (``store.fetch`` raises on the decode
    thread while it starts), so the warm batchmate loads what it needs."""
    _, _, _, _, prompts, refs = ms
    decode_thread = threading.get_ident()
    with _engine(ms, slots=6, io_retries=0) as eng:
        rt = eng.runtime
        assert rt.cache.num_slots < 2 * rt.store.num_layers
        eng.serve_all(_reqs(prompts[:1]))          # warm prompt-0's experts
        orig, orig_start = rt.store.fetch, rt.start_session
        cold = {"on": False}
        failed = []

        def start(prompt, n):
            cold["on"] = np.array_equal(prompt.numpy(), prompts[1])
            try:
                return orig_start(prompt, n)
            finally:
                cold["on"] = False

        def down(keys):
            if cold["on"] and threading.get_ident() == decode_thread:
                # a miss of the cold session: none of its keys is cached
                failed.append(not any(rt.cache.contains(k) for k in keys))
                raise OSError("host store unreachable")
            return orig(keys)

        rt.start_session, rt.store.fetch = start, down
        res = eng.serve_all(_reqs(prompts), concurrency=2)
        rt.store.fetch = orig
        del rt.start_session
    assert failed and all(failed)                  # the cold session missed
    assert res[0].tokens == refs[0]                # its batchmate: untouched
    assert res[0].finish_reason == "length"
    assert res[1].finish_reason == "io_error"


# ---------------------------------------------------------------------------
# per-request deadlines
# ---------------------------------------------------------------------------

def test_request_deadline_retires_session_batchmate_completes(ms):
    """A request with an expired wall-clock budget falls out of the batched
    round with finish_reason="deadline"; its batchmate still commits the
    full reference stream."""
    _, _, _, _, prompts, refs = ms
    reqs = [Request(prompt=prompts[0], max_new_tokens=TOK,
                    deadline_s=1e-4),
            Request(prompt=prompts[1], max_new_tokens=TOK)]
    with _engine(ms) as eng:
        res = eng.serve_all(reqs, concurrency=2)
    assert res[0].finish_reason == "deadline"
    assert len(res[0].tokens) < TOK
    assert res[0].tokens == refs[0][:len(res[0].tokens)]  # prefix, not wrong
    assert res[1].tokens == refs[1]
    assert res[1].finish_reason == "length"
