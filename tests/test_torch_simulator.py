"""PyTorch port, the calibrated simulator (``core/simulator.py``, numpy
only) and the predictor's Observation-I analytics: the reference's nine
tests of the paper's orderings (tests/test_simulator.py) run on the port's
copy, and every ``simulate(model, env, dataset=...)`` result of the port
equals the reference's field for field, exactly (both are numpy with the
same seed)."""
import dataclasses

import numpy as np
import pytest

from repro.core import predictor as jax_predictor
from repro.core import simulator as jax_simulator
from repro_torch.core import predictor
from repro_torch.core.simulator import (DATASETS, ENVS, SIM_MODELS,
                                        simulate)


def _tpot(model, policy, seeds=(0, 1, 2), **kw):
    return float(np.mean([simulate(model, policy=policy, seed=s,
                                   out_tokens=60, **kw).tpot for s in seeds]))


@pytest.mark.parametrize("model", list(SIM_MODELS))
def test_spmoe_beats_all_baselines(model):
    sp = _tpot(model, "spmoe")
    for base in ("on-demand", "moe-infinity", "adapmoe"):
        assert sp < _tpot(model, base), (model, base)


def test_on_demand_is_worst():
    for model in SIM_MODELS:
        mo = _tpot(model, "on-demand")
        for other in ("moe-infinity", "adapmoe", "spmoe"):
            assert _tpot(model, other) < mo


def test_hit_rate_pattern_table3():
    """AdapMoE hit > SP-MoE hit for mixtral (yet SP-MoE wins on TPOT);
    SP-MoE hit rate is the highest for deepseek."""
    def hit(model, policy):
        return float(np.mean([simulate(model, policy=policy, seed=s,
                                       out_tokens=60).hit_rate
                              for s in (0, 1, 2)]))
    assert hit("mixtral-8x7b", "adapmoe") > hit("mixtral-8x7b", "spmoe")
    ds = "deepseek-v2-lite-16b"
    sp = hit(ds, "spmoe")
    for other in ("on-demand", "moe-infinity", "adapmoe"):
        assert sp > hit(ds, other)


def test_cutoff_u_shape_mixtral_monotone_deepseek():
    """Fig 14: U-shape for mixtral (best strictly between 0 and max), and
    deepseek improves monotonically (within noise) with depth."""
    def sweep(model, cuts):
        return [float(np.mean([simulate(model, policy="spmoe", cutoff=c,
                                        seed=s, out_tokens=60).tpot
                               for s in (0, 1, 2)])) for c in cuts]
    mix = sweep("mixtral-8x7b", [0, 10, 20, 31])
    assert min(mix[1], mix[2]) < mix[0]       # improves from 0
    assert min(mix[1], mix[2]) < mix[3]       # over-prefetch hurts (U-shape)
    ds = sweep("deepseek-v2-lite-16b", [0, 12, 25])
    assert ds[2] < ds[0]
    assert ds[1] < ds[0]


def test_ablation_ordering_fig12():
    """baseline > +vp > +wp >= +wp+b (TPOT decreasing)."""
    base = _tpot("mixtral-8x7b", "on-demand")
    vp = _tpot("mixtral-8x7b", "spmoe", worker_prefetch=False, batched_io=False)
    wp = _tpot("mixtral-8x7b", "spmoe", worker_prefetch=True, batched_io=False)
    wpb = _tpot("mixtral-8x7b", "spmoe", worker_prefetch=True, batched_io=True)
    assert vp < base
    assert wp < vp
    assert wpb <= wp * 1.02


def test_draft_len_narrows_gap_fig13():
    """Longer drafts: SP-MoE stays (near-)fastest at every draft length, and
    the gap to the on-demand baseline narrows from N=1 to N=4 (Fig. 13 —
    'performance gaps narrow slightly with longer draft token length')."""
    seeds = tuple(range(5))
    gaps = []
    for n in (1, 2, 4):
        od = _tpot("mixtral-8x7b", "on-demand", seeds=seeds, draft_len=n)
        ad = _tpot("mixtral-8x7b", "adapmoe", seeds=seeds, draft_len=n)
        sp = _tpot("mixtral-8x7b", "spmoe", seeds=seeds, draft_len=n)
        assert sp < od
        assert sp < ad * 1.05          # within noise of the best baseline
        gaps.append(od / sp)
    assert gaps[2] < gaps[0]           # narrowing


def test_memory_sweep_fig11():
    """More GPU memory -> lower (or equal) TPOT for SP-MoE; SP-MoE lowest
    under the tightest budget."""
    tp = [_tpot("deepseek-v2-lite-16b", "spmoe", gpu_mem_gb=g)
          for g in (10, 24, 39)]
    assert tp[2] <= tp[0] * 1.05
    for pol in ("on-demand", "moe-infinity", "adapmoe"):
        assert _tpot("deepseek-v2-lite-16b", pol, gpu_mem_gb=10) >= tp[0] * 0.95


def test_sd_speedup_vs_no_sd():
    """SD itself reduces TPOT (the premise of the paper)."""
    sd = _tpot("mixtral-8x7b", "spmoe", draft_len=4)
    no_sd = _tpot("mixtral-8x7b", "spmoe", sd_enabled=False)
    assert sd < no_sd


def test_determinism():
    a = simulate("mixtral-8x7b", policy="spmoe", seed=7, out_tokens=40)
    b = simulate("mixtral-8x7b", policy="spmoe", seed=7, out_tokens=40)
    assert a.tpot == b.tpot and a.hit_rate == b.hit_rate


@pytest.mark.parametrize("model", list(SIM_MODELS))
def test_every_result_equals_the_references(model):
    assert list(SIM_MODELS) == list(jax_simulator.SIM_MODELS)
    assert {n: dataclasses.asdict(e) for n, e in ENVS.items()} == \
        {n: dataclasses.asdict(e) for n, e in jax_simulator.ENVS.items()}
    assert DATASETS == jax_simulator.DATASETS
    assert dataclasses.asdict(SIM_MODELS[model]) == \
        dataclasses.asdict(jax_simulator.SIM_MODELS[model])
    for env in ENVS:
        for dataset in DATASETS:
            got = simulate(model, env, dataset=dataset)
            want = jax_simulator.simulate(model, env, dataset=dataset)
            assert dataclasses.asdict(got) == dataclasses.asdict(want), \
                (model, env, dataset)


def test_predictor_analytics_equal_the_references():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((32, 8))
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    counts = rng.integers(0, 50, (8,)).astype(np.float64)
    np.testing.assert_array_equal(predictor.entropy(probs),
                                  jax_predictor.entropy(probs))
    got = predictor.strategy_entropies(probs, counts)
    assert got == jax_predictor.strategy_entropies(probs, counts)
    assert got["gating_based"] < got["coarse_grained"] <= got["random"]
    assert got["random"] == pytest.approx(3.0)
    for a, b in ((np.array([0, 1]), np.array([1, 2])),
                 (np.array([3, 5]), np.array([5, 3])),
                 (np.array([0, 1]), np.array([2, 3]))):
        assert predictor.activation_overlap(a, b) == \
            jax_predictor.activation_overlap(a, b)
    assert predictor.activation_overlap(np.array([3, 5]),
                                        np.array([5, 3])) == 1.0
