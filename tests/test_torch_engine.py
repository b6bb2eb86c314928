"""PyTorch port, serving: the port's ``Engine`` on ``device="cpu"`` with
the JAX reference's weights (through ``params_from_jax``).

* one sd × spmoe run emits the JAX engine's tokens, and its stream holds
  against both packages' teacher-forced forward;
* every {greedy, sd, sd-adaptive} × {none, spmoe, on-demand} combination
  emits the port's own greedy reference token for token;
* the fast verify path syncs with the host at most twice per block;
* the cache's page table, LRU and device mirror stay consistent under a
  tight cache and under concurrent prefetching;
* the hot path never reads the target model's expert weights.

Reduced mixtral in f32, prompts made from a seed with numpy."""
import threading

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
from repro_torch.core.cache import ExpertCache
from repro_torch.core.engine import (Engine, EngineConfig, Request,
                                     derive_draft_config)
from repro_torch.core.offload import HostExpertStore
from repro_torch.core.prefetcher import Prefetcher
from repro_torch.core.sd import greedy_generate
from repro_torch.models.convert import load_jax_params
from repro_torch.models.registry import build_model

TOK = 12


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
    prompt = np.random.default_rng(2).integers(0, cfg.vocab_size, (1, 6))
    ref = greedy_generate(target, torch.from_numpy(prompt), TOK, 64).tolist()
    return dict(jcfg=jcfg, jdcfg=jdcfg, jtp=jtp, jdp=jdp, cfg=cfg, dcfg=dcfg,
                target=target, draft=draft, prompt=prompt, ref=ref)


def _engine(ms, decode="sd", offload="spmoe", slots=8, **over):
    over.setdefault("draft_len", 3)
    over.setdefault("max_seq", 64)
    return Engine(EngineConfig(model=ms["cfg"], draft=ms["dcfg"],
                               decode=decode, offload=offload,
                               cache_slots=slots, **over),
                  ms["target"], ms["draft"])


def _ample(ms):
    return ms["cfg"].num_moe_layers * ms["cfg"].num_experts


def test_sd_spmoe_matches_jax_engine_tokens(ms):
    """Both engines prefetch synchronously (``prefetch_mode="vanilla"``), so
    each block's hit/miss split, and with it how the expert products are
    grouped, follows from the request alone and not from thread timing."""
    config = JaxEngineConfig(model=ms["jcfg"], draft=ms["jdcfg"], decode="sd",
                             offload="spmoe", cache_slots=8, draft_len=3,
                             max_seq=64, prefetch_mode="vanilla")
    with JaxEngine(config, ms["jtp"], ms["jdp"]) as jeng:
        want = jeng.submit(JaxRequest(prompt=jnp.asarray(ms["prompt"]),
                                      max_new_tokens=TOK)).tokens
    with _engine(ms, prefetch_mode="vanilla") as eng:
        got = eng.submit(Request(prompt=ms["prompt"], max_new_tokens=TOK))
    assert got.tokens == want
    assert got.tokens == ms["ref"]
    assert got.finish_reason == "length"


def test_sd_spmoe_stream_teacher_forced_against_jax(ms):
    """The emitted stream, teacher-forced through both packages' model: f32
    logits agree at atol 1e-4, and the argmaxes (and the emitted tokens)
    agree wherever the top-2 margin exceeds 1e-3 (the two levels of
    lossless: a near-tie may flip on either side).  Teacher forcing is
    ``prefill`` of the prompt and one ``decode_step`` over the rest of the
    stream: the reference's ``forward`` routes a sequence of more than 8
    tokens with capacity drops (its training route), which serving never
    does."""
    with _engine(ms, prefetch_mode="vanilla") as eng:
        got = eng.submit(Request(prompt=ms["prompt"], max_new_tokens=TOK))
    rest = np.asarray(got.tokens[:-1])[None]
    P = ms["prompt"].shape[1]
    jm = jax_build(ms["jcfg"])
    jl0, jc = jm.prefill(ms["jtp"], jnp.asarray(ms["prompt"]), 64)
    jl1, _, _ = jm.decode_step(ms["jtp"], jc, jnp.asarray(rest), P)
    jl = np.concatenate([np.asarray(jl0), np.asarray(jl1)[0]])
    tl0, tc = ms["target"].prefill(torch.from_numpy(ms["prompt"]), 64)
    tl1, _, _ = ms["target"].decode_step(tc, torch.from_numpy(rest), P)
    tl = torch.cat([tl0, tl1[0]]).numpy()
    np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=0)
    top2 = np.sort(jl, axis=-1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 1e-3
    assert clear.any()
    assert (tl.argmax(-1) == jl.argmax(-1))[clear].all()
    assert (np.asarray(got.tokens) == jl.argmax(-1))[clear].all()


@pytest.mark.parametrize("offload", ["none", "spmoe", "on-demand"])
@pytest.mark.parametrize("decode", ["greedy", "sd", "sd-adaptive"])
def test_lossless_against_the_ports_greedy(ms, decode, offload):
    with _engine(ms, decode=decode, offload=offload, max_draft_len=5) as eng:
        res = eng.submit(Request(prompt=ms["prompt"], max_new_tokens=TOK))
    assert res.tokens == ms["ref"], (decode, offload)
    assert res.metrics.tokens == TOK


def test_fast_path_syncs_at_most_twice_per_block(ms):
    """Ample cache holding every expert: the fast path arms and never falls
    back; a fast verify block syncs once inside ``_verify_block`` (the
    all-hit flag) and once more for the accept/reject argmax."""
    with _engine(ms, slots=_ample(ms)) as eng:
        rt = eng.runtime
        eng.submit(Request(prompt=ms["prompt"], max_new_tokens=4))
        assert rt.prefetcher.drain(timeout=30)
        every = [(l, e) for l in range(rt.store.num_layers)
                 for e in range(rt.store.num_experts)]
        missing = [k for k in every if not rt.cache.contains(k)]
        rt.cache.insert(missing, rt.store.fetch(missing))
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
        res = eng.submit(Request(prompt=ms["prompt"], max_new_tokens=16))
        assert rt.cache.check_invariants()
    fast = [s for s, is_fast in per_block if is_fast]
    assert fast, "fast path never engaged"
    assert max(fast) == 1
    assert per_turn and max(per_turn) <= 2
    assert res.metrics.fast_blocks == len(fast)
    assert res.metrics.fast_fallbacks == 0
    ref = greedy_generate(ms["target"], torch.from_numpy(ms["prompt"]), 16,
                          64).tolist()
    assert res.tokens == ref


def test_tight_cache_loads_evicts_and_stays_consistent(ms):
    with _engine(ms, slots=6) as eng:
        res = eng.submit(Request(prompt=ms["prompt"], max_new_tokens=TOK))
        assert eng.runtime.cache.check_invariants()
    assert res.tokens == ms["ref"]
    assert res.metrics.on_demand_loads > 0
    assert res.metrics.evictions > 0


def test_hot_path_never_reads_resident_expert_weights(ms):
    """Zeroing the model's expert tensors after the engine copied them to
    its host store must not change a single token."""
    cfg = ms["cfg"]
    target = build_model(cfg, "cpu")
    target.load_state_dict(ms["target"].state_dict())
    with Engine(EngineConfig(model=cfg, draft=ms["dcfg"], decode="sd",
                             offload="spmoe", cache_slots=_ample(ms),
                             draft_len=3, max_seq=64),
                target, ms["draft"]) as eng:
        for blk in target.layers:
            for n in ("wg", "wu", "wd"):
                getattr(blk.moe, n).data.zero_()
        res = eng.submit(Request(prompt=ms["prompt"], max_new_tokens=10))
    assert res.tokens == ms["ref"][:10]


def test_stream_matches_submit_and_stop_tokens(ms):
    with _engine(ms) as eng:
        streamed = list(eng.stream(Request(prompt=ms["prompt"],
                                           max_new_tokens=TOK)))
        stop = ms["ref"][4]
        res = eng.submit(Request(prompt=ms["prompt"], max_new_tokens=TOK,
                                 stop_tokens=(stop,)))
    assert streamed == ms["ref"]
    assert res.finish_reason == "stop"
    assert res.tokens == ms["ref"][:ms["ref"].index(stop) + 1]


def test_cache_consistent_under_concurrent_prefetch(ms):
    """The prefetch worker and a compute loop hammer the cache at once;
    page table, LRU and the device mirror must agree throughout."""
    store = HostExpertStore(ms["cfg"], ms["target"])
    L, E = store.num_layers, store.num_experts
    cache = ExpertCache(6, store.buffer_shapes(), torch.float32,
                        table_shape=(L, E), device="cpu")
    pf = Prefetcher(store, cache, mode="worker", batched=True)
    stop = threading.Event()
    errs = []

    def compute_loop():
        rng = np.random.default_rng(1)
        try:
            while not stop.is_set():
                keys = [(int(rng.integers(L)), int(rng.integers(E)))
                        for _ in range(3)]
                _, misses = cache.lookup(keys)
                if misses:
                    cache.insert(misses, store.fetch(misses), mark_used=True)
                with cache.lock:
                    assert cache.check_invariants()
        except Exception as e:      # surface across the thread boundary
            errs.append(e)

    t = threading.Thread(target=compute_loop)
    t.start()
    rng = np.random.default_rng(2)
    for _ in range(60):
        pf.submit([(int(rng.integers(L)), int(rng.integers(E)))
                   for _ in range(4)])
    assert pf.drain(timeout=30)
    stop.set()
    t.join(timeout=30)
    assert not t.is_alive()
    pf.stop()
    assert not errs, errs
    assert not pf.errors, pf.errors
    assert cache.check_invariants()
    for (l, e), s in cache.table.items():
        assert torch.equal(cache.bufs["wg"][s], store.expert("wg", l, e))


def test_store_staging_double_buffer_and_checksums(ms):
    store = HostExpertStore(ms["cfg"], ms["target"])
    a = store.fetch([(0, 0), (1, 1)])
    snap = {n: t.clone() for n, t in a.items()}
    b = store.fetch([(2, 2), (3, 3), (0, 5)])      # the other buffer
    for n in store.names:
        assert torch.equal(a[n], snap[n])
        assert torch.equal(b[n][0], store.expert(n, 2, 2))
    assert store.verify_payload([(2, 2), (3, 3), (0, 5)], b) == []
    b["wd"][1].view(torch.uint8).view(-1)[0] ^= 0xFF
    assert store.verify_payload([(2, 2), (3, 3), (0, 5)], b) == [1]
