"""PyTorch port, the training entry points (``launch/train.py::Trainer`` and
``main``, ``examples/train_lm_torch.py``) on the CPU: the port's versions
of ``tests/test_system.py``'s training tests (loss decreases; 10 steps
straight equal 5 + restart + 5 bit for bit; gradient compression
converges; an injected failure at step 9 resumes from the step-8
checkpoint and finishes with 12 losses), the example's failure and
restart, and the entry points asking for the card (raising without one)
unless told ``--device cpu``.  A tiny llama3.2-3b (2 layers, d 32) as in
the reference's tests, a tiny mixtral for the MoE train route, and tiny
mamba2-780m / zamba2-7b for the SSD families' train route (the plain scan;
the kernel's wrapper is never called) with their f32 ``A_log`` / ``D`` /
``dt_bias`` through the checkpoint; the launcher trains mamba2 too."""
import importlib.util
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs.base import RunConfig, ShapeConfig
from repro_torch.configs.registry import get_config
from repro_torch.launch import train as launcher
from repro_torch.launch.train import Trainer
from repro_torch.models import moe as MOE

torch.set_num_threads(1)  # pytest -n: several processes share the cores

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def _tiny_trainer(ckpt_dir=None, arch="llama3.2-3b", grad_compress=False,
                  device="cpu"):
    cfg = get_config(arch).reduced(num_layers=2, d_model=32, num_heads=2,
                                   num_kv_heads=2, head_dim=16, d_ff=64,
                                   vocab_size=128)
    shape = ShapeConfig("tiny", 32, 4, "train")
    run = RunConfig(warmup_steps=2, total_steps=40, learning_rate=3e-3)
    return Trainer(cfg, shape, run, device=device, ckpt_dir=ckpt_dir,
                   grad_compress=grad_compress), cfg


@pytest.mark.parametrize("arch", ["llama3.2-3b", "mixtral-8x7b"])
def test_training_loss_decreases(arch, monkeypatch):
    calls = []
    grouped = MOE.moe_grouped
    monkeypatch.setattr(MOE, "moe_grouped",
                        lambda p, x, c: calls.append(p) or grouped(p, x, c))
    tr, cfg = _tiny_trainer(arch=arch)
    _, losses = tr.train(25, log_every=0)
    first = np.mean(losses[:5])
    last = np.mean(losses[-5:])
    assert last < first - 0.1, (first, last)
    assert len(tr.step_s) == 25 and tr.step_ms == []   # no card: no events
    if cfg.is_moe:   # S 32 > 8: every MoE layer, forward and remat recompute
        for blk in tr.model.layers:
            assert sum(p is blk.moe for p in calls) == 25 * 2


def test_checkpoint_restart_resumes_identically():
    """Train 10 straight vs train 5 + restart + 5: identical params, bit for
    bit on the CPU (the data pipeline is restart-stable, the checkpoint is
    exact, the optimizer's step count comes back with it)."""
    with tempfile.TemporaryDirectory() as d1:
        tr, _ = _tiny_trainer()
        state_a, losses_a = tr.train(10, log_every=0)
        tr2, _ = _tiny_trainer(ckpt_dir=d1)
        tr2.train(5, ckpt_every=5, log_every=0)
        tr3, _ = _tiny_trainer(ckpt_dir=d1)
        state_b, losses_b = tr3.train(10, log_every=0)
    assert losses_b == losses_a[5:]
    assert int(state_b["opt"].step) == 10
    for n, a in state_a["params"].items():
        assert torch.equal(a, state_b["params"][n]), n
    for a, b in zip(state_a["opt"].m.values(), state_b["opt"].m.values()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ["mamba2-780m", "zamba2-7b"])
def test_ssd_family_trains_and_restarts_bit_for_bit(arch, monkeypatch):
    """The Trainer trains the SSD families unchanged: the loss falls over 25
    steps without one call of the scan kernel's wrapper ``ops.ssd``; 10
    steps straight equal 5 + restart + 5 bit for bit, and the checkpoint
    holds the mamba blocks' f32 parameters as f32."""
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.kernels import ops
    from repro_torch.models import mamba as M
    wrapper, calls = ops.ssd, []
    monkeypatch.setattr(M.ops, "ssd",
                        lambda *a: calls.append(1) or wrapper(*a))
    tr, cfg = _tiny_trainer(arch=arch)
    _, losses = tr.train(25, log_every=0)
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.1, losses
    assert calls == []
    f32 = [n for n, p in tr.model.named_parameters()
           if n.endswith(("mamba.A_log", "mamba.D", "mamba.dt_bias"))]
    assert f32 and all(dict(tr.model.named_parameters())[n].dtype ==
                       torch.float32 for n in f32)
    with tempfile.TemporaryDirectory() as d:
        tr, _ = _tiny_trainer(arch=arch)
        state_a, losses_a = tr.train(10, log_every=0)
        tr2, _ = _tiny_trainer(ckpt_dir=d, arch=arch)
        state_5, _ = tr2.train(5, ckpt_every=5, log_every=0)
        saved = Checkpointer(d).restore(5, state_5)
        for n in f32:
            assert saved["params"][n].dtype == torch.float32, n
            assert torch.equal(saved["params"][n], state_5["params"][n]), n
        tr3, _ = _tiny_trainer(ckpt_dir=d, arch=arch)
        state_b, losses_b = tr3.train(10, log_every=0)
    assert losses_b == losses_a[5:]
    for n, a in state_a["params"].items():
        assert torch.equal(a, state_b["params"][n]), n
    for n, a in state_a["opt"].m.items():
        assert torch.equal(a, state_b["opt"].m[n]), n


def test_training_with_grad_compression_converges():
    tr, _ = _tiny_trainer(grad_compress=True)
    state, losses = tr.train(25, log_every=0)
    assert np.mean(losses[-5:]) < np.mean(losses[:5])
    assert set(state) == {"params", "opt", "ef"}


def test_supervised_training_with_failure_and_restart():
    """Injected failure mid-run; restart restores from checkpoint and
    completes the remaining steps."""
    with tempfile.TemporaryDirectory() as d:
        tr, _ = _tiny_trainer(ckpt_dir=d)
        with pytest.raises(RuntimeError, match="injected failure at step 9"):
            tr.train(20, ckpt_every=4, fail_at=9, log_every=0)
        assert tr.ckpt.latest_step() == 8
        tr2, _ = _tiny_trainer(ckpt_dir=d)
        _, losses = tr2.train(20, ckpt_every=4, log_every=0)
        assert len(losses) == 12              # resumed from step 8
        assert tr2.ckpt.steps() == [12, 16, 20]   # keep 3


def _example():
    spec = importlib.util.spec_from_file_location(
        "train_lm_torch", EXAMPLES / "train_lm_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_train_lm_example_recovers_from_a_failure_on_the_cpu(capsys):
    """A failure at step 26 resumes from the step-25 checkpoint."""
    out = _example().main(["--device", "cpu", "--steps", "28", "--fail-at",
                           "26"])
    assert out["failed_at"] == 26 and out["resumed_from"] == 25
    assert len(out["losses"]) == 3 and np.isfinite(out["losses"]).all()
    printed = capsys.readouterr().out
    assert "restarting from checkpoint step 25" in printed
    assert "recovered; final loss" in printed


def test_launcher_trains_on_the_cpu(capsys):
    losses = launcher.main(["--arch", "mixtral-8x7b", "--reduced", "--steps",
                            "3", "--batch", "2", "--seq", "16", "--device",
                            "cpu"])
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert "final loss" in capsys.readouterr().out


def test_launcher_trains_an_ssd_family_model_on_the_cpu(capsys):
    losses = launcher.main(["--arch", "mamba2-780m", "--reduced", "--steps",
                            "3", "--batch", "2", "--seq", "40", "--device",
                            "cpu"])
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert "final loss" in capsys.readouterr().out


def test_training_entry_points_ask_for_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        _tiny_trainer(device=None)
    with pytest.raises(RuntimeError, match="CUDA"):
        launcher.main(["--arch", "llama3.2-3b", "--reduced", "--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        _example().main(["--steps", "2"])
    monkeypatch.setattr(sys, "argv", ["train", "--arch", "llama3.2-3b"])
    with pytest.raises(RuntimeError, match="CUDA"):
        launcher.main()
