"""Lays a model, its optimizer state and its batches out over a
``DeviceMesh`` by the sharding rules (``models/sharding.py``), as DTensors.
One layout serves the dry-run's trace (``launch/dryrun.py``, fake tensors
over a fake process group) and the run that trains on a mesh
(``launch/train.py::Trainer(mesh=...)``, real tensors over a real one), so
the dry-run's records describe the step that trains.

GSPMD plans the whole program; DTensor places one op at a time.  What this
layout adds so that a step keeps the layout the rules mean:

* the layout mesh (``layout_mesh``): on a mesh with both ``pod`` and
  ``data``, those two dims are flattened into one, ``pod_data``
  (``DeviceMesh._flatten``), and every tensor lives on the 2-D (pod_data,
  model) mesh.  The rules shard a dim over ``("pod", "data")`` together
  (FSDP weights, the batch), which is one ``Shard`` on one mesh dim there:
  gathered in one all-gather, its gradient reduced in one reduce-scatter.
  Over two mesh dims DTensor's redistribution planner searches a graph of
  placements for every such gradient (hours for a train step on the
  2 x 16 x 16 mesh);
* FSDP: a weight sharded over the FSDP dim is all-gathered over it where
  it is read (``gather_on_use``), as XLA gathers per layer;
* the residual stream between blocks is pinned to the batch sharding
  (``pin_residual``): a row-parallel partial sum is all-reduced there;
* for the dry-run's trace, an op DTensor cannot place as laid out is run
  on inputs all-gathered (``Reshard``) and counted, never silently.  The
  run that trains has no such fallback: an op it cannot place raises.

``place_params`` takes a model's own parameters: their values where they
have them (each rank keeps its own shard; every rank must hold the same
whole tensor, as a model built from one seed does), zeros of their shape
for a model on the meta device (under ``FakeTensorMode``: fake tensors).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import torch
from torch._subclasses.fake_tensor import unset_fake_temporarily
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import (DTensor, Placement, Replicate, Shard,
                                      distribute_tensor)
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves, tree_map

from repro_torch.models import sharding as SH

# the flattened (pod x data) mesh dim
POD_DATA = "pod_data"


def _flat_name(mesh: DeviceMesh) -> bool:
    names = mesh.mesh_dim_names or ()
    return "pod" in names and "data" in names


def layout_mesh(mesh: DeviceMesh) -> DeviceMesh:
    """The mesh the tensors live on: ``mesh`` itself, or for a mesh with
    ``pod`` and ``data`` the (pod_data, model) mesh over the same ranks
    (made once per mesh)."""
    if not _flat_name(mesh):
        return mesh
    cached = getattr(mesh, "_repro_layout", None)
    if cached is not None:
        return cached
    rest = [n for n in mesh.mesh_dim_names if n not in ("pod", "data")]
    with unset_fake_temporarily():          # the mesh's own rank tensors
        flat = mesh["pod", "data"]._flatten(POD_DATA)
        if hasattr(DeviceMesh, "_concatenate"):
            out = DeviceMesh._concatenate([flat] + [mesh[n] for n in rest])
        else:                               # older PyTorch: slice the root
            out = mesh[(POD_DATA, *rest)]
    mesh._repro_layout = out
    return out


def layout_spec(spec: SH.Spec, mesh: DeviceMesh) -> SH.Spec:
    """``spec`` (the rules' axis names) in the layout mesh's names: a dim
    over ``("pod", "data")`` is over ``pod_data``."""
    if not _flat_name(mesh):
        return spec
    out = []
    for axes in spec:
        names = (axes,) if isinstance(axes, str) else tuple(axes or ())
        if "pod" in names or "data" in names:
            if names[:2] != ("pod", "data"):
                raise ValueError(f"spec {spec}: pod and data shard a dim "
                                 f"together, pod first, or not at all")
            names = (POD_DATA,) + names[2:]
        out.append(None if not names else
                   names[0] if len(names) == 1 else names)
    return tuple(out)


def placements(spec: SH.Spec, mesh: DeviceMesh) -> List[Placement]:
    """The placements of ``spec`` on ``layout_mesh(mesh)``."""
    return SH.placements(layout_spec(spec, mesh), layout_mesh(mesh))


def fsdp_dims(mesh: DeviceMesh) -> List[int]:
    """The layout mesh's FSDP dims (``pod_data``, or ``data`` alone)."""
    names = list(layout_mesh(mesh).mesh_dim_names)
    return [names.index(a) for a in (POD_DATA, "data") if a in names]


def distribute(t: torch.Tensor, mesh: DeviceMesh, spec: SH.Spec) -> DTensor:
    """``t`` (the whole tensor, the same on every rank) as a DTensor laid
    out by ``spec``; each rank keeps its own shard (nothing is sent, and
    nothing of the whole tensor is kept)."""
    lm = layout_mesh(mesh)
    out = distribute_tensor(t, lm, placements(spec, mesh),
                            src_data_rank=None)
    local = out.to_local()
    if local.numel() != t.numel():          # a view of t: keep the shard
        out = DTensor.from_local(local.clone(), lm, out.placements,
                                 run_check=False, shape=out.shape,
                                 stride=out.stride())
    return out


def distribute_tree(tree: Any, specs: Any, mesh: DeviceMesh) -> Any:
    """``distribute`` over a nested dict / list of tensors and its specs
    (as from ``cache_pspecs``); other leaves are kept."""
    if isinstance(tree, dict):
        return {k: distribute_tree(v, specs[k], mesh)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [distribute_tree(v, s, mesh) for v, s in zip(tree, specs)]
    if isinstance(tree, torch.Tensor):
        return distribute(tree, mesh, specs)
    return tree


def batch_spec(shape: Sequence[int], mesh: DeviceMesh) -> SH.Spec:
    """``batch_pspec``: the batch over (pod, data) where the dim divides
    (else replicated: long_500k's global batch of 1), the rest whole."""
    return (SH._fit(shape[0], mesh, SH.data_axes(mesh)),) + \
        (None,) * (len(shape) - 1)


def distribute_batch(batch: Dict[str, torch.Tensor], mesh: DeviceMesh
                     ) -> Dict[str, DTensor]:
    return {k: distribute(t, mesh, batch_spec(t.shape, mesh))
            for k, t in batch.items()}


def distribute_microbatches(batch: Dict[str, torch.Tensor],
                            mesh: DeviceMesh, n: int):
    """A global batch laid out for a train step with ``n`` microbatches:
    ``distribute_batch`` of it (n <= 1), or the list of its n microbatches,
    rows ``[i·B/n, (i+1)·B/n)`` as the reference splits them, each one
    sharded over the data dims (``models/train.py`` takes either)."""
    if not n or n <= 1:
        return distribute_batch(batch, mesh)
    b = next(iter(batch.values())).shape[0]
    if b % n:
        raise ValueError(f"batch {b} not divisible by microbatch {n}")
    return [distribute_batch({k: v[i * b // n:(i + 1) * b // n]
                              for k, v in batch.items()}, mesh)
            for i in range(n)]


def gather_on_use(mod, leaf: str, placements):
    """FSDP's gather-on-use: ``mod.<leaf>``, stored sharded over the FSDP
    dim as ``mod.<leaf>_fsdp``, reads as its all-gather over it (once per
    use, layer by layer, and again where remat recomputes it; the gradient
    flows back as a reduce-scatter), the counterpart of XLA gathering FSDP
    weights per layer inside the scan.  A property on a subclass made for
    ``mod`` (no module is called, so no module hook fires)."""
    stored = mod._parameters.pop(leaf)
    mod.register_parameter(leaf + "_fsdp", stored)
    # one mesh dim at a time, the inner first: each step (and its
    # reduce-scatter in the backward) a plain one-dim collective
    steps, now = [], list(stored.placements)
    for i in reversed(range(len(now))):
        if now[i] != placements[i]:
            now[i] = placements[i]
            steps.append(list(now))

    def read(self):
        w = getattr(self, leaf + "_fsdp")
        for p in steps:
            w = w.redistribute(w.device_mesh, p)
        return w
    mod.__class__ = type(type(mod).__name__, (type(mod),),
                         {leaf: property(read)})
    return stored


def place_params(model, specs: Optional[Dict[str, SH.Spec]],
                 mesh: DeviceMesh, requires_grad: bool, fsdp: bool = False
                 ) -> Dict[str, torch.Tensor]:
    """Swap every parameter of ``model`` for its layout by its spec (a
    DTensor; ``specs=None``: kept whole, a plain tensor): its own values,
    or zeros of its shape on the meta device.  With ``fsdp`` a parameter
    sharded over the FSDP dim is gathered over it on use.  -> {name:
    stored parameter}, by the model's own names."""
    gathered = fsdp_dims(mesh) if (fsdp and specs is not None) else []
    stored = {}
    for name, p in list(model.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        mod = model.get_submodule(owner) if owner else model
        t = torch.zeros(p.shape, dtype=p.dtype) if p.is_meta else p.detach()
        if specs is not None:
            t = distribute(t, mesh, specs[name])
        setattr(mod, leaf, torch.nn.Parameter(t, requires_grad=requires_grad))
        stored[name] = getattr(mod, leaf)
        if any(isinstance(t.placements[i], Shard) for i in gathered):
            gather_on_use(mod, leaf, [
                Replicate() if i in gathered else pl
                for i, pl in enumerate(t.placements)])
    if stored:                   # where the rank's tensors are (fake: cpu)
        model.device = local(next(iter(stored.values()))).device
    return stored


def pin_residual(model, mesh: DeviceMesh):
    """The residual stream between blocks (and into the head) sharded over
    the batch alone: over the data dims where it is, replicated over
    model, as the rules lay activations out.  A row-parallel product's
    partial sum is all-reduced there, as in Megatron-style tensor
    parallelism; without the pin DTensor's op-by-op propagation carries it
    into the next block and may reduce-scatter it over the sequence."""
    if not hasattr(model, "_block"):
        return
    names = layout_mesh(mesh).mesh_dim_names
    data = [i for i, a in enumerate(names) if a != "model"]

    def pin(x):
        if not isinstance(x, DTensor):
            return x
        return x.redistribute(x.device_mesh, [
            p if i in data and p == Shard(0) else Replicate()
            for i, p in enumerate(x.placements)])
    embed, block, logits = model.embed, model._block, model.logits
    model.embed = lambda tokens: pin(embed(tokens))
    model._block = lambda *a, **k: (lambda out: (pin(out[0]),) + out[1:])(
        block(*a, **k))
    model.logits = lambda x: logits(pin(x))


def whole(a):
    """A DTensor's whole tensor on every rank (an all-gather)."""
    return a.full_tensor() if isinstance(a, DTensor) else a


def local(a):
    """A DTensor's shard on this rank; any other tensor itself."""
    return a.to_local() if isinstance(a, DTensor) else a


def _has_dtensor(tree) -> bool:
    return any(isinstance(a, DTensor) for a in tree_leaves(tree))


def _plain_target(func, args) -> bool:
    """Whether ``func`` writes its first operand and that is a plain
    tensor."""
    return bool(func._schema.is_mutable and args and
                isinstance(args[0], torch.Tensor) and
                not isinstance(args[0], DTensor))


class Reshard(TorchDispatchMode):
    """Where a DTensor op does not run as laid out (DTensor has no
    strategy for it on these placements or none at all, fails in one, or
    its redistribution planner reads a fake tensor's values), its DTensor
    inputs are all-gathered (``_reshard``) and it runs on them, as GSPMD
    inserts an all-gather where a sharding cannot be kept; it is counted
    in ``resharded``.  Under a fake mode this runs with the fake mode
    lifted (the inputs and outputs stay fake), and its outputs are handed
    to ``tracker`` (a ``MemTracker``, which sees no op run outside the
    fake mode it was entered under)."""

    def __init__(self, tracker=None):
        super().__init__()
        self.tracker = tracker
        self.resharded: Dict[str, int] = {}
        self.last_op = None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self.last_op = str(func)
        # an in-place op on a plain tensor with DTensor operands goes to the
        # whole tensors at once: tried on DTensors it may write its target
        # and then raise (it would be applied twice)
        if not (_plain_target(func, args) and _has_dtensor((args, kwargs))):
            try:
                return func(*args, **kwargs)
            except Exception:
                if not _has_dtensor((args, kwargs)):
                    raise
        with unset_fake_temporarily():
            out = self._reshard(func, args, kwargs)
        self.resharded[str(func)] = self.resharded.get(str(func), 0) + 1
        if self.tracker is not None:
            self.tracker.track_external(*[t for t in tree_leaves(out)
                                          if isinstance(t, torch.Tensor)])
        return out

    @staticmethod
    def _reshard(func, args, kwargs):
        """Run ``func`` with its DTensor inputs replicated over the last
        mesh dim (``model``); where that fails too (an op DTensor has no
        strategy for at all), on their whole tensors, its results
        replicated again (an in-place op's written back into its target's
        own layout)."""
        def over_model(a):
            if not isinstance(a, DTensor):
                return a
            last = a.device_mesh.ndim - 1
            return a.redistribute(a.device_mesh, [
                Replicate() if i == last else p
                for i, p in enumerate(a.placements)])
        target = args[0] if args else None
        if not _plain_target(func, args):
            try:
                return func(*tree_map(over_model, args),
                            **tree_map(over_model, kwargs))
            except Exception:
                pass
        mesh = next(a.device_mesh for a in tree_leaves((args, kwargs))
                    if isinstance(a, DTensor))
        rep = [Replicate()] * mesh.ndim
        out = func(*tree_map(whole, args), **tree_map(whole, kwargs))
        if func._schema.is_mutable and isinstance(target, DTensor):
            back = DTensor.from_local(out, mesh, rep, run_check=False
                                      ).redistribute(mesh, target.placements)
            target.to_local().copy_(back.to_local())
            return target
        if func._schema.is_mutable and isinstance(target, torch.Tensor):
            return out                          # a plain target, updated
        return tree_map(lambda t: DTensor.from_local(
            t, mesh, rep, run_check=False)
            if isinstance(t, torch.Tensor) else t, out)
