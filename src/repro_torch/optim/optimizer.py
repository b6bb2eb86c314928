"""Optimizers: AdamW (f32 moments) and AdamW8bit (block-quantized int8
moments with per-block f32 scales), the warmup + cosine schedule and global
gradient clipping.  The port of ``repro.optim.optimizer``.

Parameters, gradients and moments are dicts of tensors keyed by the
parameters' names, the moments on the parameters' device.  ``update`` works
in place, one parameter at a time (so its temporaries are one parameter's
size), and computes what the reference computes: f32 moments, the bias
corrections ``1 - b^step``, decoupled weight decay on ``p`` and the learning
rate at ``step + 1``.  The step count is a 0-d int32 tensor on the host, so
the learning rate and the bias corrections are host scalars (f32 arithmetic,
as the reference's) and an update reads nothing back from the device.

The int8 blocks of 256 are the reference's: it quantizes each leaf of its
tree, and a stacked leaf ``[L, ...]`` holds every layer's tensor,
flattened in layer order.  Where a layer's tensor is a whole number of
blocks, its own blocks are the stack's; the other stacks (the SSD
families' per-head vectors, narrow norms) are given as ``groups``
(``models/convert.py::stack_groups``, worked out once from the model's
parameters by the train step and the ``Trainer``), quantized as one
flattened concatenation of their layers' tensors under the group's key
(``layers.*.mamba.A_log``), and split back into the parameters before the
update.  Without groups each parameter is quantized alone.

On a mesh (``launch/train.py::Trainer(mesh=...)``) parameters, gradients
and f32 moments are DTensors laid out alike, and every op above computes
what it computes on the global tensors: the global norm sums every shard
(DTensor reduces the partial sums), and the int8 blocks of 256 are those
of the global flattened tensor, as in the reference (``quantize_i8``; a
group's members are gathered whole, ``quantize_stack``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import (Callable, Dict, Iterable, List, Mapping, NamedTuple,
                    Optional, Sequence, Tuple)

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)

Tensors = Dict[str, torch.Tensor]
Groups = Mapping[str, Sequence[str]]   # group key -> member names


# ---------------------------------------------------------------------------
# schedule
# ---------------------------------------------------------------------------

def warmup_cosine(base_lr: float, warmup: int, total: int,
                  final_frac: float = 0.1) -> Callable[[int], float]:
    """step -> learning rate: linear warmup, then cosine decay to
    ``final_frac · base_lr``; f32 arithmetic throughout, as the
    reference's."""
    f32 = np.float32

    def lr(step: int) -> float:
        s = f32(step)
        if s < warmup:
            return float(f32(base_lr) * np.minimum(s / f32(max(warmup, 1)),
                                                   f32(1.0)))
        prog = np.clip((s - f32(warmup)) / f32(max(total - warmup, 1)),
                       f32(0.0), f32(1.0))
        cos = f32(final_frac) + f32((1 - final_frac) * 0.5) * (
            f32(1.0) + np.cos(f32(np.pi) * prog))
        return float(f32(base_lr) * cos)
    return lr


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in f32 (0-d tensor on
    the tensors' device)."""
    total = None
    for x in tensors:
        sq = torch.sum(torch.square(x.float()))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def clip_by_global_norm(grads: Tensors, max_norm: float
                        ) -> Tuple[Tensors, torch.Tensor]:
    """Scale every gradient by min(1, max_norm / norm), in place; -> (grads,
    norm)."""
    norm = global_norm(grads.values())
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    for g in grads.values():
        g.mul_(scale.to(g.dtype))
    return grads, norm


# ---------------------------------------------------------------------------
# int8 block quantization (shared by AdamW8bit and gradient compression)
# ---------------------------------------------------------------------------

QBLOCK = 256


def _block_placements(x: DTensor):
    """The placements under which the 256-blocks of ``x``'s global
    flattening ([nb, 256]) are laid out as ``x`` is, so that each rank's
    blocks are those of its own shard: ``x`` split only along dim 0 (or
    not at all; a mesh dim of size 1 splits nothing), evenly, into runs of
    whole blocks.  None otherwise."""
    pls = tuple(Replicate() if n == 1 else p
                for n, p in zip(x.device_mesh.shape, x.placements))
    if any(not (isinstance(p, Replicate) or p == Shard(0)) for p in pls):
        return None
    k = math.prod(n for n, p in zip(x.device_mesh.shape, pls)
                  if isinstance(p, Shard))
    if k > 1:
        rows = x.shape[0]
        run = rows // k * math.prod(x.shape[1:])
        if rows % k or run % QBLOCK:
            return None
    return pls


def quantize_i8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x -> (int8 values [nb, 256], f32 per-block scales [nb, 1]); blocks
    along the flattened tensor, the last one zero-padded.  A DTensor's
    blocks are those of its global tensor: where its shards are runs of
    whole blocks (``_block_placements``) each rank quantizes its own shard
    and keeps its blocks, laid out alike; else the tensor is gathered (one
    tensor at a time) and the blocks split over every mesh dim."""
    if isinstance(x, DTensor):
        mesh = x.device_mesh
        pls = _block_placements(x)
        if pls is None:
            return tuple(distribute_tensor(t, mesh, [Shard(0)] * mesh.ndim,
                                           src_data_rank=None)
                         for t in quantize_i8(x.full_tensor()))
        nb = -(-x.numel() // QBLOCK)
        return tuple(DTensor.from_local(t, mesh, pls, run_check=False,
                                        shape=(nb, t.shape[1]),
                                        stride=(t.shape[1], 1))
                     for t in quantize_i8(x.to_local()))
    flat = x.float().reshape(-1)
    flat = F.pad(flat, (0, (-flat.numel()) % QBLOCK)).reshape(-1, QBLOCK)
    scale = torch.amax(torch.abs(flat), dim=1, keepdim=True) / 127.0
    q = torch.round(flat / torch.clamp(scale, min=1e-20)).to(torch.int8)
    return q, scale


def dequantize_i8(q: torch.Tensor, scale: torch.Tensor, shape,
                  dtype: torch.dtype = torch.float32,
                  like: torch.Tensor = None) -> torch.Tensor:
    """The tensor of ``shape`` that ``quantize_i8`` gave (q, scale); of
    DTensor blocks, laid out as ``like`` (a DTensor of that shape)."""
    if isinstance(q, DTensor):
        if tuple(q.placements) == _block_placements(like):
            local = like.to_local()
            t = dequantize_i8(q.to_local(), scale.to_local(), local.shape,
                              dtype)
            return DTensor.from_local(t, like.device_mesh, like.placements,
                                      run_check=False, shape=like.shape,
                                      stride=like.stride())
        full = dequantize_i8(q.full_tensor(), scale.full_tensor(), shape,
                             dtype)
        return distribute_tensor(full, like.device_mesh, like.placements,
                                 src_data_rank=None)
    flat = (q.float() * scale).reshape(-1)
    n = int(np.prod(shape))
    return flat[:n].reshape(shape).to(dtype)


def block_units(params: Mapping[str, torch.Tensor],
                groups: Optional[Groups] = None) -> Dict[str, List[str]]:
    """The tensors quantized together, under the keys the int8 state keeps
    them: each parameter alone under its own name, then ``groups``."""
    groups = groups or {}
    grouped = {n for names in groups.values() for n in names}
    return {**{n: [n] for n in params if n not in grouped},
            **{k: list(names) for k, names in groups.items()}}


def quantize_stack(xs: Sequence[torch.Tensor]
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``quantize_i8`` of the tensors flattened and concatenated in order
    (a unit of ``block_units``; one tensor is quantized as it is).  The
    DTensors of a group are gathered whole first, and the blocks split
    over every mesh dim, as ``quantize_i8`` lays out the blocks of a
    tensor it cannot quantize on its shards."""
    if len(xs) == 1:
        return quantize_i8(xs[0])
    if isinstance(xs[0], DTensor):
        mesh = xs[0].device_mesh
        return tuple(distribute_tensor(t, mesh, [Shard(0)] * mesh.ndim,
                                       src_data_rank=None)
                     for t in quantize_stack([x.full_tensor() for x in xs]))
    return quantize_i8(torch.cat([x.reshape(-1) for x in xs]))


def dequantize_stack(q: torch.Tensor, scale: torch.Tensor,
                     likes: Sequence[torch.Tensor],
                     dtype: torch.dtype = torch.float32
                     ) -> List[torch.Tensor]:
    """The tensors that ``quantize_stack`` gave (q, scale), each shaped and
    (a DTensor) laid out as its member of ``likes`` (tensors or shapes)."""
    if len(likes) == 1:
        x = likes[0]
        return [dequantize_i8(q, scale, getattr(x, "shape", x), dtype,
                              like=x)]
    if isinstance(q, DTensor):
        whole = dequantize_stack(q.full_tensor(), scale.full_tensor(),
                                 [x.shape for x in likes], dtype)
        return [distribute_tensor(t, x.device_mesh, x.placements,
                                  src_data_rank=None)
                for t, x in zip(whole, likes)]
    shapes = [torch.Size(x) if not isinstance(x, torch.Tensor) else x.shape
              for x in likes]
    sizes = [math.prod(s) for s in shapes]
    flat = dequantize_i8(q, scale, (sum(sizes),), dtype)
    return [t.reshape(s) for t, s in zip(torch.split(flat, sizes), shapes)]


def _bias_corrections(b1: float, b2: float, step: int) -> Tuple[float, float]:
    """1 - b^step for both betas, in f32."""
    f32 = np.float32
    return (float(f32(1.0) - f32(b1) ** f32(step)),
            float(f32(1.0) - f32(b2) ** f32(step)))


def _apply(p: torch.Tensor, m: torch.Tensor, v: torch.Tensor, b1c: float,
           b2c: float, eps: float, weight_decay: float, lr: float):
    """p <- p - lr · ((m / b1c) / (sqrt(v / b2c) + eps) + wd · p), in f32,
    cast back to p's dtype."""
    den = torch.sqrt(v / b2c).add_(eps)
    u = torch.div(m, b1c).div_(den)
    del den
    pf = p.float()
    u.add_(pf, alpha=weight_decay).mul_(lr)
    if p.dtype == torch.float32:
        p.sub_(u)
    else:
        p.copy_(pf.sub_(u))


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

class AdamState(NamedTuple):
    step: torch.Tensor          # 0-d int32, on the host
    m: Tensors
    v: Tensors


@dataclass(frozen=True)
class AdamW:
    lr_fn: Callable[[int], float]
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0

    def init(self, params: Tensors) -> AdamState:
        def zeros():       # each laid out as its parameter (a DTensor too)
            return {n: torch.zeros_like(p, dtype=torch.float32)
                    for n, p in params.items()}
        return AdamState(torch.zeros((), dtype=torch.int32), zeros(),
                         zeros())

    @torch.no_grad()
    def update(self, grads: Tensors, state: AdamState, params: Tensors):
        """-> (params, state, {"grad_norm", "lr"}); params, grads and the
        moments are updated in place."""
        grads, gnorm = clip_by_global_norm(grads, self.grad_clip)
        step = int(state.step) + 1
        lr = self.lr_fn(step)
        b1c, b2c = _bias_corrections(self.b1, self.b2, step)
        for name, p in params.items():
            m, v = state.m[name], state.v[name]
            gf = grads[name].float()
            m.mul_(self.b1).add_(gf, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(gf, gf, value=1 - self.b2)
            del gf
            _apply(p, m, v, b1c, b2c, self.eps, self.weight_decay, lr)
        return params, AdamState(torch.tensor(step, dtype=torch.int32),
                                 state.m, state.v), {
            "grad_norm": gnorm, "lr": lr}


# ---------------------------------------------------------------------------
# AdamW with 8-bit states
# ---------------------------------------------------------------------------

class Adam8bitState(NamedTuple):
    step: torch.Tensor          # 0-d int32, on the host
    m_q: Tensors
    m_s: Tensors
    v_q: Tensors
    v_s: Tensors


@dataclass(frozen=True)
class AdamW8bit:
    """AdamW with int8 moments in 256-blocks; ``groups``: the stacks
    quantized as one (``models/convert.py::stack_groups``)."""
    lr_fn: Callable[[int], float]
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    groups: Groups = field(default_factory=dict)

    def init(self, params: Tensors) -> Adam8bitState:
        qs = {key: quantize_stack([torch.zeros_like(params[n],
                                                    dtype=torch.float32)
                                   for n in names])
              for key, names in block_units(params, self.groups).items()}
        mq = {n: q for n, (q, _) in qs.items()}
        ms = {n: s for n, (_, s) in qs.items()}
        return Adam8bitState(torch.zeros((), dtype=torch.int32), mq, ms,
                             {n: t.clone() for n, t in mq.items()},
                             {n: t.clone() for n, t in ms.items()})

    @torch.no_grad()
    def update(self, grads: Tensors, state: Adam8bitState, params: Tensors):
        """-> (params, state, {"grad_norm", "lr"}); params, grads and the
        state's dicts are updated in place (each moment requantized into
        new tensors that replace the old ones one unit of ``block_units``
        at a time)."""
        grads, gnorm = clip_by_global_norm(grads, self.grad_clip)
        step = int(state.step) + 1
        lr = self.lr_fn(step)
        b1c, b2c = _bias_corrections(self.b1, self.b2, step)
        mq, ms, vq, vs = state.m_q, state.m_s, state.v_q, state.v_s
        for key, names in block_units(params, self.groups).items():
            ps = [params[n] for n in names]
            m_all = dequantize_stack(mq[key], ms[key], ps)
            v_all = dequantize_stack(vq[key], vs[key], ps)
            for name, p, m, v in zip(names, ps, m_all, v_all):
                # the reference's b m + (1 - b) g and b v + (1 - b) g g,
                # each product and sum rounded on its own (no fused
                # multiply-add), so that its int8 moments come out
                gf = grads[name].float()     # (the gradient itself if f32)
                m.mul_(self.b1).add_(gf * (1 - self.b1))
                v.mul_(self.b2).add_((gf * (1 - self.b2)).mul_(gf))
                del gf
                v.clamp_(min=0.0)  # the reference's maximum(v2, 0): a
                #                    no-op, v2 is never negative
                _apply(p, m, v, b1c, b2c, self.eps, self.weight_decay, lr)
            mq[key], ms[key] = quantize_stack(m_all)
            vq[key], vs[key] = quantize_stack(v_all)
        return params, Adam8bitState(torch.tensor(step, dtype=torch.int32),
                                     mq, ms, vq, vs), {
            "grad_norm": gnorm, "lr": lr}


def make_optimizer(name: str, lr_fn, weight_decay: float = 0.1,
                   grad_clip: float = 1.0, groups: Optional[Groups] = None):
    """``groups`` (the int8 stacks) is AdamW8bit's; AdamW has no blocks."""
    if name == "adamw":
        return AdamW(lr_fn, weight_decay=weight_decay, grad_clip=grad_clip)
    if name == "adamw8bit":
        return AdamW8bit(lr_fn, weight_decay=weight_decay,
                         grad_clip=grad_clip, groups=dict(groups or {}))
    raise ValueError(name)
