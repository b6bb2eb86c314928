"""PyTorch port, the reference's last public functions with a counterpart
here: ``core/sd.py::sd_generate`` / ``sd_generate_adaptive`` (the cases of
``tests/test_sd.py``: lossless over three archs and three draft lengths,
fixed seeds in place of its hypothesis soak, a perfect draft accepting
everything, the adaptive controller growing and holding N), each against
the reference's tokens and stats from the same weights (through
``load_jax_params``) and against the port's greedy; ``ExpertCache.hit_rate``
/ ``slots_of``, ``HostExpertStore.expert_bytes``,
``ExpertPredictor.predict_all``, ``configs/registry.py::arch_ids`` and the
engine result's ``token_tensor`` (the reference's ``token_array``), each
against the reference's."""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import arch_ids as jax_arch_ids
from repro.configs.registry import get_config as jax_config
from repro.core.cache import ExpertCache as JaxCache
from repro.core.engine import GenerationResult as JaxResult
from repro.core.engine import Metrics as JaxMetrics
from repro.core.engine import derive_draft_config as jax_derive
from repro.core.offload import HostExpertStore as JaxStore
from repro.core.predictor import ExpertPredictor as JaxPredictor
from repro.core.sd import greedy_generate as jax_greedy
from repro.core.sd import sd_generate as jax_sd
from repro.core.sd import sd_generate_adaptive as jax_sd_adaptive
from repro.models.registry import build_model as jax_build
from repro_torch.configs.registry import arch_ids, get_config
from repro_torch.core.cache import ExpertCache
from repro_torch.core.engine import (GenerationResult, Metrics,
                                     derive_draft_config)
from repro_torch.core.offload import HostExpertStore
from repro_torch.core.predictor import ExpertPredictor
from repro_torch.core.sd import (greedy_generate, sd_generate,
                                 sd_generate_adaptive)
from repro_torch.models.convert import load_jax_params
from repro_torch.models.registry import build_model

torch.set_num_threads(1)  # pytest -n: several processes share the cores


@functools.lru_cache(maxsize=None)
def _setup(arch, seed=0, draft_seed=1):
    """The reference's target and derived draft (reduced, f32) with their
    weights, and the port's models holding the same weights."""
    jcfg = jax_config(arch).reduced(dtype="float32")
    jdcfg = jax_derive(jcfg)
    jt, jd = jax_build(jcfg), jax_build(jdcfg)
    jtp = jt.init(jax.random.PRNGKey(seed))
    jdp = jd.init(jax.random.PRNGKey(draft_seed))
    cfg = get_config(arch).reduced(dtype="float32")
    target = load_jax_params(build_model(cfg, "cpu"),
                             jax.tree.map(np.asarray, jtp))
    draft = load_jax_params(build_model(derive_draft_config(cfg), "cpu"),
                            jax.tree.map(np.asarray, jdp))
    return jcfg, jt, jd, jtp, jdp, target, draft


def _prompt(key: int, n: int, vocab: int):
    p = jax.random.randint(jax.random.PRNGKey(key), (1, n), 0, vocab)
    return p, torch.from_numpy(np.array(p)).long()


def _same_stats(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k] == pytest.approx(float(v), rel=1e-12), k


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "deepseek-v2-lite-16b",
                                  "llama3.2-3b"])
@pytest.mark.parametrize("draft_len", [1, 3, 5])
def test_sd_generate_lossless(arch, draft_len):
    jcfg, jt, jd, jtp, jdp, target, draft = _setup(arch)
    jp, tp = _prompt(2, 8, jcfg.vocab_size)
    ref, ref_stats = jax_sd(jd, jt, jdp, jtp, jp, 20, draft_len, 64)
    out, stats = sd_generate(draft, target, tp, 20, draft_len, 64)
    assert out.tolist() == greedy_generate(target, tp, 20, 64).tolist()
    assert out.tolist() == ref.tolist()
    _same_stats(stats, ref_stats)


@pytest.mark.parametrize("seed,draft_len", [(3, 2), (1234, 6), (9001, 4)])
def test_sd_generate_lossless_for_any_draft(seed, draft_len):
    """The reference's property test at three fixed draws: a random draft
    of its own seed, the target of seed % 7."""
    jcfg, jt, jd, jtp, jdp, target, draft = _setup(
        "mixtral-8x7b", seed=seed % 7, draft_seed=seed)
    jp, tp = _prompt(seed, 5, jcfg.vocab_size)
    out, _ = sd_generate(draft, target, tp, 12, draft_len, 48)
    assert out.tolist() == greedy_generate(target, tp, 12, 48).tolist()
    assert out.tolist() == jax_greedy(jt, jtp, jp, 12, 48).tolist()


def test_sd_generate_perfect_draft_accepts_everything():
    jcfg, jt, _, jtp, _, target, _ = _setup("llama3.2-3b")
    jp, tp = _prompt(2, 6, jcfg.vocab_size)
    out, stats = sd_generate(target, target, tp, 16, 4, 64)
    ref, ref_stats = jax_sd(jt, jt, jtp, jtp, jp, 16, 4, 64)
    assert out.tolist() == greedy_generate(target, tp, 16, 64).tolist()
    assert out.tolist() == ref.tolist()
    assert stats["acceptance_rate"] > 0.99
    assert stats["tokens_per_iteration"] >= 4.9
    _same_stats(stats, ref_stats)


def test_sd_generate_adaptive_lossless_and_adapts():
    jcfg, jt, jd, jtp, _, target, _ = _setup("llama3.2-3b")
    jp, tp = _prompt(2, 6, jcfg.vocab_size)
    ref = greedy_generate(target, tp, 20, 96).tolist()
    # perfect draft (same model): N grows toward max
    out, stats = sd_generate_adaptive(target, target, tp, 20, 96, min_len=1,
                                      max_len=6)
    want, want_stats = jax_sd_adaptive(jt, jt, jtp, jtp, jp, 20, 96,
                                       min_len=1, max_len=6)
    assert out.tolist() == ref == want.tolist()
    assert stats["final_draft_len"] >= 4
    _same_stats(stats, want_stats)
    # useless draft (random weights): N stays at the floor, still lossless
    _, _, jd9, _, jdp9, _, draft9 = _setup("llama3.2-3b", draft_seed=9)
    out2, stats2 = sd_generate_adaptive(draft9, target, tp, 20, 96,
                                        min_len=1, max_len=6)
    want2, want_stats2 = jax_sd_adaptive(jd9, jt, jdp9, jtp, jp, 20, 96,
                                         min_len=1, max_len=6)
    assert out2.tolist() == ref == want2.tolist()
    _same_stats(stats2, want_stats2)


def test_arch_ids_are_the_references():
    assert arch_ids() == jax_arch_ids()


def test_cache_hit_rate_and_slots_of_match_the_reference():
    """The same inserts and lookups on both caches: the same hit rate after
    each lookup, the same slot of every cached key."""
    jc = JaxCache(3, {"w": (2,)}, np.float32)
    tc = ExpertCache(3, {"w": (2,)}, torch.float32, device="cpu")
    assert tc.hit_rate() == jc.hit_rate() == 0.0
    ops = [("insert", [(0, 0), (0, 1)]), ("lookup", [(0, 0), (1, 1)]),
           ("insert", [(1, 1), (0, 2)]), ("lookup", [(0, 1), (0, 2)]),
           ("lookup", [(1, 1), (0, 0), (0, 2)])]
    for op, keys in ops:
        if op == "insert":
            jc.insert(keys, {"w": np.ones((len(keys), 2), np.float32)})
            tc.insert(keys, {"w": torch.ones((len(keys), 2))})
        else:
            jc.lookup(keys)
            tc.lookup(keys)
        assert tc.hit_rate() == jc.hit_rate()
        cached = sorted(jc.table)
        assert sorted(tc.table) == cached
        got = tc.slots_of(cached)
        assert got.dtype == torch.int32
        assert got.tolist() == np.asarray(jc.slots_of(cached)).tolist()
    with pytest.raises(KeyError):
        tc.slots_of([(9, 9)])
    tc.reset_stats()
    assert tc.hit_rate() == 0.0


def test_expert_bytes_and_predict_all_match_the_reference():
    jcfg, jt, _, jtp, _, target, _ = _setup("mixtral-8x7b")
    cfg = get_config("mixtral-8x7b").reduced(dtype="float32")
    store = HostExpertStore(cfg, target)
    assert store.expert_bytes() == JaxStore(jcfg, jtp).expert_bytes() > 0
    L = store.num_layers
    taps = np.random.default_rng(4).standard_normal(
        (L, 1, 1, cfg.d_model)).astype(np.float32)
    port, ref = ExpertPredictor(cfg, target, 2), JaxPredictor(jcfg, jtp, 2)
    for cutoff in (0, L - 2, L - 1, L + 3):
        got = port.predict_all(torch.from_numpy(taps), cutoff)
        assert got == ref.predict_all(jax.numpy.asarray(taps), cutoff)
        assert len({k[0] for k in got}) == min(cutoff + 1, L)


def test_token_tensor_is_the_references_token_array():
    toks = [5, 0, 17, 3]
    got = GenerationResult(toks, "length", Metrics()).token_tensor()
    want = JaxResult(toks, "length", JaxMetrics()).token_array()
    assert got.tolist() == np.asarray(want).tolist()
