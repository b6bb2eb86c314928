"""Training entry point: data pipeline -> train step -> checkpoint ->
fault-tolerant supervision.  The port of ``repro/launch/train.py``.

Without a mesh the model, its gradients and the optimizer state live on
``device`` (the card by default; without one it raises, pass
``device="cpu"`` to train on the CPU).  With the reference's ``mesh`` (a
``DeviceMesh`` over the default process group, ``launch/mesh.py``) every
rank builds the model from the seed on its own device (the mesh's device
type; for ``cuda`` the rank's card, raising where there is none), lays
each parameter out by ``param_pspecs(cfg, ..., mode="train")`` through
``models/placement.py`` (FSDP over the data dims, gathered on use; TP over
``model``), keeps its optimizer state laid out as its parameters, and
keeps its own shard of every batch: each rank draws the same global batch
from the seed, so the data stay restart-stable.  Every op of a step on a
mesh runs as DTensor places it (the capacity route's data-dependent
routing on each rank's own rows, ``models/moe.py``); one it cannot place
raises.  A step reads one value back to the host, the loss, as the
reference's ``float(metrics["loss"])`` does.

    PYTHONPATH=src python -m repro_torch.launch.train --arch mixtral-8x7b \\
        --reduced --steps 50 --device cpu
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, List, Optional

import torch
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs.base import RunConfig, ShapeConfig
from repro_torch.configs.registry import get_config
from repro_torch.data.pipeline import make_pipeline
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import placement as P
from repro_torch.models import sharding as SH
from repro_torch.models.convert import stack_groups
from repro_torch.models.registry import build_model
from repro_torch.models.train import make_train_step
from repro_torch.optim.grad_compress import init_error_feedback
from repro_torch.optim.optimizer import (QBLOCK, make_optimizer,
                                         warmup_cosine)
from repro_torch.runtime.fault_tolerance import Heartbeat, StragglerDetector


class Trainer:
    """Trains ``cfg`` on the synthetic pipeline at ``shape``'s batch and
    length.  Weights are drawn from ``seed`` (``DecoderLM``'s generator)
    by each ``init_state``; ``train`` also draws its data from it.
    ``step_ms`` holds each step's time on the card (CUDA events around the
    step; empty on the CPU), ``step_s`` its host time, which ends in the
    loss readback, and ``metrics`` its metrics as the step returned them
    (0-d device tensors, read by no step).

    An encdec model (whisper) is refused: the pipeline gives no ``frames``,
    as the reference's gives none; it trains through
    ``models/train.py::make_train_step`` with a batch that holds them.

    ``mesh``: train on that ``DeviceMesh`` (see the module docstring); the
    state's parameters and moments are DTensors, and the metrics are read
    whole.  ``device`` must then be None or the mesh's device."""

    def __init__(self, cfg, shape: ShapeConfig, run: RunConfig, mesh=None,
                 device: DeviceLike = None, ckpt_dir: Optional[str] = None,
                 grad_compress: bool = False, seed: int = 0):
        if cfg.family == "encdec":
            raise ValueError(
                f"{cfg.name}: the Trainer's data pipeline gives no frames "
                f"for an encdec model; train it through "
                f"models/train.py::make_train_step with a batch that holds "
                f"frames [B, encoder_seq, d_model]")
        self.cfg, self.shape, self.run = cfg, shape, run
        self.mesh = mesh
        if mesh is not None:
            device = _mesh_device(mesh, device)
        self.device = resolve_device(device)
        self.seed = seed
        self.opt = self._optimizer()
        self.grad_compress = grad_compress
        self.model = None
        self.step_fn = None
        self.ckpt = Checkpointer(ckpt_dir) if ckpt_dir else None
        self.heartbeat = Heartbeat(host_id=0)
        self.straggler = StragglerDetector()
        self.step_ms: List[float] = []
        self.step_s: List[float] = []
        self.metrics: List[Dict[str, Any]] = []

    def _optimizer(self, groups=None):
        """The run's optimizer; ``groups``: the model's int8 stacks
        (``convert.stack_groups``), known once the model is built."""
        run = self.run
        return make_optimizer(
            run.optimizer, warmup_cosine(run.learning_rate, run.warmup_steps,
                                         run.total_steps),
            weight_decay=run.weight_decay, grad_clip=run.grad_clip,
            groups=groups)

    def init_state(self, seed: Optional[int] = None) -> Dict[str, Any]:
        """A fresh model from ``seed`` (default: the trainer's), its
        parameters requiring grad, and a fresh optimizer state:
        ``{"params", "opt"}`` (and ``"ef"`` with gradient compression)."""
        self.model = self.step_fn = None       # free the last one first
        self.model = build_model(self.cfg, self.device,
                                 seed=self.seed if seed is None else seed)
        if self.mesh is None:
            for p in self.model.parameters():
                p.requires_grad_(True)
            params = dict(self.model.named_parameters())
        else:
            specs = SH.param_pspecs(self.cfg,
                                    dict(self.model.named_parameters()),
                                    self.mesh, mode="train")
            params = P.place_params(self.model, specs, self.mesh,
                                    requires_grad=True, fsdp=True)
            P.pin_residual(self.model, self.mesh)
        self.opt = self._optimizer(stack_groups(params, QBLOCK))
        self.step_fn = make_train_step(self.model, self.cfg, self.run,
                                       self.opt,
                                       grad_compress=self.grad_compress)
        state: Dict[str, Any] = {"params": params,
                                 "opt": self.opt.init(params)}
        if self.grad_compress:
            state["ef"] = init_error_feedback(params)
        return state

    def restore_or_init(self, seed: Optional[int] = None):
        """(start step, state): the latest checkpoint's, copied into a fresh
        model's parameters, or step 0 and a fresh state."""
        state = self.init_state(seed)
        start = 0
        if self.ckpt is not None:
            latest = self.ckpt.latest_step()
            if latest is not None:
                saved = self.ckpt.restore(latest, state)
                with torch.no_grad():
                    for name, p in state["params"].items():
                        p.copy_(saved["params"][name])
                state = {**saved, "params": state["params"]}
                start = latest
        return start, state

    def train(self, steps: int, ckpt_every: int = 0,
              seed: Optional[int] = None, fail_at: Optional[int] = None,
              log_every: int = 10):
        """Run steps [start, steps) from the latest checkpoint (or 0) ->
        (state, losses)."""
        seed = self.seed if seed is None else seed
        start, state = self.restore_or_init(seed)
        pipe = make_pipeline(self.cfg, self.shape, seed=seed,
                             start_step=start)
        cuda = self.device.type == "cuda"
        losses = []
        try:
            for step in range(start, steps):
                if fail_at is not None and step == fail_at:
                    raise RuntimeError(f"injected failure at step {step}")
                batch = {k: torch.from_numpy(v).to(self.device)
                         for k, v in next(pipe).items()}
                if self.mesh is not None:
                    batch = P.distribute_microbatches(batch, self.mesh,
                                                      self.run.microbatch)
                t0 = time.perf_counter()
                if cuda:
                    ev = [torch.cuda.Event(enable_timing=True)
                          for _ in range(2)]
                    ev[0].record()
                state, metrics = self._step(state, batch)
                if cuda:
                    ev[1].record()
                loss = float(metrics["loss"])     # the step's one readback
                dt = time.perf_counter() - t0
                if cuda:
                    self.step_ms.append(ev[0].elapsed_time(ev[1]))
                self.step_s.append(dt)
                self.metrics.append(metrics)
                losses.append(loss)
                self.heartbeat.beat()
                self.straggler.observe(0, dt)
                if ckpt_every and self.ckpt and (step + 1) % ckpt_every == 0:
                    self.ckpt.save(step + 1, state)
                if log_every and step % log_every == 0:
                    print(f"step {step} loss {loss:.4f} "
                          f"lr {float(metrics['lr']):.2e}", flush=True)
        finally:
            pipe.close()
            if self.ckpt:
                self.ckpt.wait()
        return state, losses

    def _step(self, state, batch):
        """One train step -> (state, metrics); on a mesh the plain tensors
        the model makes (positions, masks, zeros) read as replicated, and
        the metrics are read whole."""
        def step():
            if self.grad_compress:
                params, opt, ef, metrics = self.step_fn(
                    state["params"], state["opt"], batch, state["ef"])
                return {"params": params, "opt": opt, "ef": ef}, metrics
            params, opt, metrics = self.step_fn(state["params"],
                                                state["opt"], batch)
            return {"params": params, "opt": opt}, metrics
        if self.mesh is None:
            return step()
        with implicit_replication():
            state, metrics = step()
        return state, {k: P.whole(v) for k, v in metrics.items()}


def _mesh_device(mesh, device: DeviceLike) -> torch.device:
    """The rank's device on ``mesh``: its device type, and for ``cuda`` the
    card the mesh set for this rank; raises where there is no card."""
    if mesh.device_type == "cuda":
        resolve_device("cuda")
        dev = torch.device("cuda", torch.cuda.current_device())
    else:
        dev = torch.device(mesh.device_type)
    if device is not None and torch.device(device).type != dev.type:
        raise ValueError(f"device {device} is not the mesh's "
                         f"{mesh.device_type}")
    return dev


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--optimizer", default="adamw")
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; cpu to train on "
                         "the CPU)")
    args = ap.parse_args(argv)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    run = RunConfig(optimizer=args.optimizer, warmup_steps=5,
                    total_steps=args.steps)
    tr = Trainer(cfg, shape, run, device=args.device, ckpt_dir=args.ckpt_dir,
                 grad_compress=args.grad_compress)
    _, losses = tr.train(args.steps, ckpt_every=args.ckpt_every)
    print(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f})")
    return losses


if __name__ == "__main__":
    main()
