"""Loss and the train step: microbatched (f32 gradient accumulation),
optimizer-fused, with optional int8 error-feedback gradient compression.
The port of ``repro/models/train.py``.

The returned step has the reference's signature, ``step(params, opt_state,
batch[, ef_state]) -> (params, opt_state[, ef_state], metrics)``, where
``params`` are the model's own parameters by name (they must require grad)
and are updated in place; ``metrics`` holds ``loss``, ``ce``, ``aux_loss``
and ``grad_norm`` as 0-d device tensors and ``lr`` as a float.  A batch is
a dict of tensors on the model's device: ``tokens`` and ``labels`` [B, S]
and, for a vlm, ``patch_embeds`` [B, P, d], for an encdec model
``frames`` [B, encoder_seq, d].  Per-layer remat is the
model's (``cfg.remat``).

On a mesh (``launch/train.py::Trainer(mesh=...)``) the parameters are
DTensors laid out by the sharding rules (``models/placement.py``), each
gradient is reduced to its parameter's layout where autograd returns it,
and the batch may come as a list of ``run.microbatch`` microbatch dicts
(each one sharded over the data dims: a global batch split as the
reference splits it, rows ``[i·B/n, (i+1)·B/n)``, cannot be sliced out of
a batch that is sharded by rows without gathering it).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.models.convert import stack_groups
from repro_torch.optim.grad_compress import compress_with_error_feedback
from repro_torch.optim.optimizer import QBLOCK

Tensors = Dict[str, torch.Tensor]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  z_loss: float = 1e-4) -> torch.Tensor:
    """Mean CE over all positions, f32, with the z-loss regularizer
    ``z_loss · lse²`` inside the mean (as the reference reports it)."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels[..., None].long())
    # subtracted before the last dim is dropped: the same values, and the
    # shape at which a vocab-sharded gather's mask is reduced on DTensors
    # (launch/dryrun.py)
    ce = (lse[..., None] - gold)[..., 0]
    return torch.mean(ce + z_loss * torch.square(lse))


def _accumulate(gsum: Tensors, grads: Tensors):
    """gsum[name] += grads[name] in f32 (the first microbatch's become the
    sums)."""
    for name, g in grads.items():
        if name in gsum:
            gsum[name].add_(g.float())
        else:
            gsum[name] = g.float()


def _as_param(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A DTensor gradient reduced to (or split into) its parameter's
    layout: a partial sum over the data dims is all-reduced, or
    reduce-scattered where the parameter is sharded there."""
    if isinstance(g, DTensor) and isinstance(p, DTensor) and \
            tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def make_loss_fn(model, cfg: ModelConfig):
    """batch -> (loss, {"ce", "aux_loss"}); loss = ce + router_aux_loss_coef
    · aux."""
    def loss_fn(batch: Tensors) -> Tuple[torch.Tensor, Tensors]:
        if cfg.family == "vlm":
            logits, aux = model.forward(batch["tokens"],
                                        patch_embeds=batch["patch_embeds"])
        elif cfg.family == "encdec":
            if "frames" not in batch:
                raise ValueError(f"{cfg.name}: an encdec batch needs frames "
                                 f"[B, encoder_seq, d_model]")
            logits, aux = model.forward(batch["tokens"], batch["frames"])
        else:
            logits, aux = model.forward(batch["tokens"])
        ce = cross_entropy(logits, batch["labels"])
        loss = ce + cfg.router_aux_loss_coef * aux
        return loss, {"ce": ce, "aux_loss": aux}
    return loss_fn


def make_train_step(model, cfg: ModelConfig, run: RunConfig, optimizer,
                    grad_compress: bool = False):
    """The train step of ``model``.

    ``run.microbatch`` > 1 splits the batch into that many microbatches run
    one after another, their gradients summed in f32, then divided and cast
    to bf16 whatever the parameter dtype, the loss averaged and ``ce`` /
    ``aux_loss`` taken from the last microbatch (all as the reference
    does).  ``grad_compress`` applies int8 error-feedback compression to the
    gradients before the update, in the reference's stacked blocks
    (``convert.stack_groups``, worked out once here)."""
    loss_fn = make_loss_fn(model, cfg)
    groups = stack_groups(dict(model.named_parameters()), QBLOCK)

    def grads_of(loss: torch.Tensor, params: Tensors) -> Tensors:
        gs = torch.autograd.grad(loss, list(params.values()),
                                 allow_unused=True)
        return {n: torch.zeros_like(p) if g is None else _as_param(g, p)
                for (n, p), g in zip(params.items(), gs)}

    def microbatches(batch, n: int):
        if isinstance(batch, (list, tuple)):
            if len(batch) != n:
                raise ValueError(f"{len(batch)} microbatches given, "
                                 f"run.microbatch is {n}")
            return list(batch)
        b = batch["tokens"].shape[0]
        if b % n:
            raise ValueError(f"batch {b} not divisible by microbatch {n}")
        return [{k: v[i * b // n:(i + 1) * b // n] for k, v in batch.items()}
                for i in range(n)]

    def compute_grads(params: Tensors, batch):
        n = run.microbatch
        if n and n > 1:
            gsum: Tensors = {}
            lsum = 0.0
            for mb in microbatches(batch, n):
                loss, aux = loss_fn(mb)
                _accumulate(gsum, grads_of(loss, params))
                lsum = lsum + loss.detach()
            grads = {}
            for name in list(gsum):
                grads[name] = gsum.pop(name).div_(n).to(torch.bfloat16)
            return lsum / n, {k: v.detach() for k, v in aux.items()}, grads
        if isinstance(batch, (list, tuple)):
            (batch,) = microbatches(batch, 1)
        loss, aux = loss_fn(batch)
        return loss.detach(), {k: v.detach() for k, v in aux.items()}, \
            grads_of(loss, params)

    def train_step(params: Tensors, opt_state, batch: Tensors,
                   ef_state=None):
        loss, aux, grads = compute_grads(params, batch)
        if grad_compress:
            grads, ef_state = compress_with_error_feedback(grads, ef_state,
                                                           groups)
        params, opt_state, om = optimizer.update(grads, opt_state, params)
        metrics = {"loss": loss, **aux, **om}
        if grad_compress:
            return params, opt_state, ef_state, metrics
        return params, opt_state, metrics

    return train_step
