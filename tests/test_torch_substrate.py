"""PyTorch port, the training substrate: the data pipeline
(``data/pipeline.py``) gives the reference's batches bit for bit for the
same (seed, host, step); the checkpointer (``checkpoint/checkpointer.py``)
and the fault-tolerance module (``runtime/fault_tolerance.py``), the
port's versions of ``tests/test_substrate.py``'s tests, plus the dtypes a
checkpoint must carry (bf16 through f32, int8 and int32 exactly) and a
save that fails raising at ``wait``."""
import os
import tempfile
import time

import numpy as np
import pytest
import torch

from repro.configs.base import ShapeConfig as JaxShape
from repro.configs.registry import get_config as jax_config
from repro.data import pipeline as JP
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import get_config
from repro_torch.data.pipeline import DataConfig, SyntheticLM, make_pipeline
from repro_torch.optim.optimizer import AdamW8bit, warmup_cosine
from repro_torch.runtime.fault_tolerance import (FailureInjector, Heartbeat,
                                                 StragglerDetector,
                                                 plan_mesh, run_supervised)

torch.set_num_threads(1)  # pytest -n: several processes share the cores


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,hosts,host,step", [
    (0, 1, 0, 0), (0, 1, 0, 7), (3, 1, 0, 123), (5, 2, 1, 4), (1, 4, 3, 9)])
def test_batches_equal_the_references(seed, hosts, host, step):
    kw = dict(vocab_size=500, seq_len=24, global_batch=8, num_hosts=hosts,
              host_id=host, seed=seed)
    got = SyntheticLM(DataConfig(**kw)).batch_at(step)
    want = JP.SyntheticLM(JP.DataConfig(**kw)).batch_at(step)
    assert set(got) == set(want) == {"tokens", "labels"}
    for k in want:
        assert got[k].dtype == want[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], want[k])


def test_pipelines_of_a_config_equal_the_references():
    cfg, jcfg = get_config("mixtral-8x7b"), jax_config("mixtral-8x7b")
    pipe = make_pipeline(cfg, ShapeConfig("t", 64, 4, "train"), seed=2,
                         start_step=3)
    jpipe = JP.make_pipeline(jcfg, JaxShape("t", 64, 4, "train"), seed=2,
                             start_step=3)
    try:
        for _ in range(3):
            got, want = next(pipe), next(jpipe)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k])
    finally:
        pipe.close()
        jpipe.close()


def test_data_deterministic_and_restart_stable():
    ds = SyntheticLM(DataConfig(vocab_size=100, seq_len=16, global_batch=4))
    a = ds.batch_at(7)
    b = ds.batch_at(7)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    np.testing.assert_array_equal(a["labels"][:, :-1], a["tokens"][:, 1:])


def test_data_host_sharding_disjoint():
    full = SyntheticLM(DataConfig(vocab_size=100, seq_len=8, global_batch=8,
                                  num_hosts=1, host_id=0)).batch_at(3)
    h0 = SyntheticLM(DataConfig(vocab_size=100, seq_len=8, global_batch=8,
                                num_hosts=2, host_id=0)).batch_at(3)
    h1 = SyntheticLM(DataConfig(vocab_size=100, seq_len=8, global_batch=8,
                                num_hosts=2, host_id=1)).batch_at(3)
    assert full["tokens"].shape == (8, 8)
    assert h0["tokens"].shape == (4, 8)
    assert not np.array_equal(h0["tokens"], h1["tokens"])
    with pytest.raises(ValueError):
        SyntheticLM(DataConfig(vocab_size=100, seq_len=8, global_batch=7,
                               num_hosts=2))


def test_prefetch_iterator_order():
    pipe = make_pipeline(type("C", (), {"vocab_size": 50})(),
                         type("S", (), {"seq_len": 8, "global_batch": 2})(),
                         start_step=5)
    ds = SyntheticLM(DataConfig(vocab_size=50, seq_len=8, global_batch=2))
    try:
        for s in (5, 6, 7):
            np.testing.assert_array_equal(next(pipe)["tokens"],
                                          ds.batch_at(s)["tokens"])
    finally:
        pipe.close()
    assert not pipe._thread.is_alive()


def test_vlm_batches_carry_patch_embeddings_after_the_references_text():
    cfg = get_config("llava-next-mistral-7b").reduced()
    pipe = make_pipeline(cfg, ShapeConfig("t", 20, 2, "train"), seed=1)
    try:
        got = next(pipe)
    finally:
        pipe.close()
    text = 20 - cfg.num_patches
    assert got["tokens"].shape == (2, text)
    assert got["patch_embeds"].shape == (2, cfg.num_patches, cfg.d_model)
    assert got["patch_embeds"].dtype == np.float32
    want = JP.SyntheticLM(JP.DataConfig(vocab_size=cfg.vocab_size,
                                        seq_len=text, global_batch=2,
                                        seed=1)).batch_at(0)
    np.testing.assert_array_equal(got["tokens"], want["tokens"])


# ---------------------------------------------------------------------------
# checkpointing
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip_and_gc():
    with tempfile.TemporaryDirectory() as d:
        ck = Checkpointer(d, keep=2)
        state = {"params": {"w": torch.arange(6, dtype=torch.float32
                                              ).reshape(2, 3)},
                 "opt": {"m": torch.ones(4)}}
        for s in (1, 2, 3):
            ck.save(s, state, blocking=True)
        assert ck.steps() == [2, 3]            # gc kept last 2
        assert ck.latest_step() == 3
        like = {k: {n: torch.zeros_like(t) for n, t in v.items()}
                for k, v in state.items()}
        out = ck.restore(3, like)
        assert torch.equal(out["params"]["w"], state["params"]["w"])
        assert torch.equal(out["opt"]["m"], state["opt"]["m"])


def test_checkpoint_atomic_no_partial_dirs():
    with tempfile.TemporaryDirectory() as d:
        ck = Checkpointer(d)
        ck.save(5, {"params": {"w": torch.ones(2)}}, blocking=True)
        assert not [f for f in os.listdir(d) if f.startswith(".tmp")]
        assert sorted(os.listdir(os.path.join(d, "step_5"))) == [
            "meta.json", "params.host0.npz"]


def test_checkpoint_carries_every_dtype_of_a_train_state():
    """bf16 widened to f32 and cast back (exact), int8 / int32 exactly, a
    named tuple's fields by name, the async save snapshotted at the call
    (a later in-place update does not reach the checkpoint)."""
    g = torch.Generator().manual_seed(0)
    params = {"w": torch.randn(3, 300, generator=g).to(torch.bfloat16),
              "b": torch.randn(5, generator=g)}
    opt = AdamW8bit(warmup_cosine(1e-3, 1, 10))
    ostate = opt.init(params)
    ostate = opt.update({n: torch.randn(p.shape, generator=g).to(p.dtype)
                         for n, p in params.items()}, ostate, params)[1]
    state = {"params": params, "opt": ostate}
    want = {n: p.clone() for n, p in params.items()}
    with tempfile.TemporaryDirectory() as d:
        ck = Checkpointer(d)
        ck.save(1, state)
        params["w"].add_(1.0)
        ck.wait()
        out = ck.restore(1, state)
    for n in params:
        assert out["params"][n].dtype == params[n].dtype
        assert torch.equal(out["params"][n], want[n])
    assert type(out["opt"]) is type(ostate)
    assert out["opt"].step.dtype == torch.int32 and int(out["opt"].step) == 1
    for f in ("m_q", "m_s", "v_q", "v_s"):
        for n, t in getattr(ostate, f).items():
            got = getattr(out["opt"], f)[n]
            assert got.dtype == t.dtype and torch.equal(got, t)


def test_a_failed_save_raises_at_wait(monkeypatch):
    with tempfile.TemporaryDirectory() as d:
        ck = Checkpointer(d)

        def broken(*a, **k):
            raise OSError("disk full")
        monkeypatch.setattr(np, "savez", broken)
        ck.save(1, {"params": {"w": torch.ones(2)}})
        with pytest.raises(RuntimeError, match="save failed"):
            ck.wait()
        assert ck.latest_step() is None


# ---------------------------------------------------------------------------
# fault tolerance
# ---------------------------------------------------------------------------

def test_plan_mesh_preserves_model_axis():
    p = plan_mesh(512, 16)
    assert p["model"] == 16 and p["data"] == 32
    p = plan_mesh(500, 16)                    # lost 12 devices
    assert p["model"] == 16 and p["data"] == 16   # largest pow2 <= 31
    assert plan_mesh(64, 4, prefer_pods=2) == {"pod": 2, "data": 8,
                                               "model": 4}
    with pytest.raises(ValueError):
        plan_mesh(8, 16)


def test_straggler_detector_flags_slow_host():
    det = StragglerDetector(threshold=2.0, patience=2)
    flagged = False
    for i in range(20):
        det.observe(0, 1.0 + 0.01 * np.random.default_rng(i).normal())
    for _ in range(3):
        flagged = det.observe(1, 5.0)
    assert flagged


def test_supervisor_restarts_and_finishes():
    """Simulated failures at steps 3 and 7; supervisor restarts from the
    last checkpoint and re-plans the mesh after device loss."""
    log = []
    fail_at = {3: True, 7: True}

    def train_loop(start, plan, devices):
        log.append((start, dict(plan), devices))
        for step in range(start, 10):
            if fail_at.pop(step, None):
                return step, False           # crash; checkpointed at `step`
        return 10, True

    inj = FailureInjector({3: 496, 7: 480})
    rep = run_supervised(train_loop, 10, 512, 16, injector=inj)
    assert rep.completed_steps == 10
    assert rep.restarts == 2
    assert rep.final_devices == 480
    assert log[0][2] == 512 and log[-1][2] == 480
    assert log[-1][1]["data"] <= log[0][1]["data"]


def test_run_supervised_reports_straggler_flags():
    def train_loop(start, plan, devices):
        obs = [(0, 0.1)] * 8 + [(1, 10.0)] * 3
        return 10, True, obs

    rep = run_supervised(train_loop, 10, 8, 2)
    assert rep.straggler_flags == [1]
    assert rep.completed_steps == 10
    rep2 = run_supervised(lambda s, p, d: (10, True), 10, 8, 2)
    assert rep2.straggler_flags == []


def test_heartbeat():
    hb = Heartbeat(0, timeout_s=0.05)
    assert hb.alive()
    time.sleep(0.08)
    assert not hb.alive()
    hb.beat()
    assert hb.alive()
