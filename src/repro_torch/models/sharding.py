"""Path-based sharding rules: a spec for every parameter, cache tensor and
batch per mesh.  The port of ``repro/models/sharding.py``.

Rules are keyed on parameter names (stable across the model zoo) with
divisibility guards: an axis is sharded only when the dim divides the mesh
axis size, so every (arch x mesh) combination distributes cleanly.

Conventions:

* ``model``            tensor-parallel axis: heads, d_ff, vocab, experts (EP
                       when E divides), ssm channels.
* ``fsdp`` = (pod, data) weight sharding for training (ZeRO-3 style, the
                       weights gathered layer by layer) and for serving
                       models too big to replicate per data shard.
* activations          batch over (pod, data).

A spec is a tuple with one entry per tensor dim: ``None`` (replicated), an
axis name, or a tuple of axis names that shard the dim together, major
first (the reference's ``PartitionSpec`` read one to one).  The rules are
pure functions of the mesh's ordered axis sizes, so they take either a
``DeviceMesh`` or a mapping ``{axis: size}`` and need no process group.
The port's layers are unstacked (``layers.<l>.attn.wq``,
``mamba_groups.<g>.<i>.mamba.in_proj``, as ``models/convert.py`` names
them), so a spec here is the reference's without its leading ``None`` per
stacked layer axis.

``placements`` turns a spec into DTensor placements on a ``DeviceMesh``;
``models/placement.py`` lays tensors out by them (the counterpart of the
reference's ``to_shardings``).
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Placement, Replicate, Shard

from repro_torch.configs.base import ModelConfig

Axes = Optional[Union[str, Tuple[str, ...]]]
Spec = Tuple[Axes, ...]
MeshLike = Union[DeviceMesh, Mapping[str, int]]


def mesh_shape(mesh: MeshLike) -> Dict[str, int]:
    """The mesh's axes and sizes, in mesh order."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return {name: mesh.size(i) for i, name in enumerate(mesh.mesh_dim_names)}


def mesh_axis_size(mesh: MeshLike, axes: Axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    shape = mesh_shape(mesh)
    return int(np.prod([shape[a] for a in axes]))


def fsdp_axes(mesh: MeshLike) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh_shape(mesh))


def data_axes(mesh: MeshLike) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh_shape(mesh))


def _fit(dim: int, mesh: MeshLike, axes: Axes) -> Axes:
    """axes if dim divides their product, else None."""
    if axes is None:
        return None
    size = mesh_axis_size(mesh, axes)
    return axes if (size > 1 and dim % size == 0) else None


def _leaf_spec(name: str, shape: Tuple[int, ...], cfg: ModelConfig,
               mesh: MeshLike, fsdp: Axes) -> Spec:
    """The spec of one parameter, by its last name and its shape."""
    M = "model"

    def ax(dim_idx, axes):
        return _fit(shape[dim_idx], mesh, axes)

    if name == "wte":                       # [V, d]
        return (ax(0, M), ax(1, fsdp))
    if name == "head":                      # [d, V]
        return (ax(0, fsdp), ax(1, M))
    if len(shape) == 1:                     # norms / biases / A_log / D
        return (None,)
    if name == "wq":                        # [d, H, hd]
        return (ax(0, fsdp), ax(1, M), None)
    if name in ("wk", "wv"):                # [d, Hkv, hd]
        return (ax(0, fsdp), ax(1, M), None)
    if name == "wo":                        # [H, hd, d]
        return (ax(0, M), None, ax(2, fsdp))
    if name in ("wdkv", "wkr"):             # [d, r]
        return (ax(0, fsdp), None)
    if name in ("wuk", "wuv"):              # [r, H, hd]
        return (ax(0, fsdp), ax(1, M), None)
    if name == "gate":                      # [d, E]: small, replicated
        return (None, None)
    if name in ("wg", "wu") and len(shape) == 3:   # experts [E, d, f]
        e = ax(0, M)
        if e is not None:
            return (e, ax(1, fsdp), None)          # EP
        return (None, ax(1, fsdp), ax(2, M))       # TP over f
    if name == "wd" and len(shape) == 3:           # experts [E, f, d]
        e = ax(0, M)
        if e is not None:
            return (e, None, ax(2, fsdp))
        return (None, ax(1, M), ax(2, fsdp))
    if name in ("wg", "wu"):                # dense ffn [d, f]
        return (ax(0, fsdp), ax(1, M))
    if name == "wd":                        # dense ffn [f, d]
        return (ax(0, M), ax(1, fsdp))
    if name == "in_proj":                   # [d, dproj]
        return (ax(0, fsdp), ax(1, M))
    if name == "conv_w":                    # [W, ch]
        return (None, ax(1, M))
    if name == "out_proj":                  # [d_in, d]
        return (ax(0, M), ax(1, fsdp))
    return (None,) * len(shape)


def serve_weight_gather(params: Mapping[str, torch.Tensor],
                        mesh: MeshLike) -> bool:
    """Serving keeps the weights FSDP-sharded when one model shard's
    replica would exceed 10 GB."""
    total = sum(t.numel() * t.element_size() for t in params.values())
    return total / max(mesh_axis_size(mesh, "model"), 1) > 10e9


def param_pspecs(cfg: ModelConfig, params: Mapping[str, torch.Tensor],
                 mesh: MeshLike, mode: str = "train",
                 weight_gather: Optional[bool] = None) -> Dict[str, Spec]:
    """{parameter name: spec} for ``params`` (name -> tensor, e.g.
    ``dict(model.named_parameters())`` of a model built on the meta
    device).

    mode="train": weights FSDP-sharded over (pod, data) + TP over model.
    mode="serve": TP only, unless the per-model-shard replica would exceed
    10 GB (or weight_gather=True): then the FSDP sharding stays on and the
    weights are gathered per layer on the fly."""
    if mode == "serve":
        if weight_gather is None:
            weight_gather = serve_weight_gather(params, mesh)
        fsdp = data_axes(mesh) if weight_gather else None
    else:
        fsdp = fsdp_axes(mesh)
    return {n: _leaf_spec(n.rsplit(".", 1)[-1], tuple(t.shape), cfg, mesh,
                          fsdp)
            for n, t in params.items()}


# a cache tensor's own rank, by name; dims before these are stacked layer
# axes (an encdec model's cross K / V ``[L, B, S_enc, Hkv, hd]``)
_CACHE_RANK = {"k": 4, "v": 4, "c_kv": 3, "k_rope": 3, "ssm": 4, "conv": 3,
               "pos_map": 1}


def _cache_leaf_spec(name: str, shape: Tuple[int, ...],
                     mesh: MeshLike) -> Spec:
    depth = len(shape) - _CACHE_RANK.get(name, len(shape))
    stack, shape = (None,) * depth, shape[depth:]
    dp = data_axes(mesh)
    if name in ("k", "v"):               # [B, S, Hkv, hd]
        b = _fit(shape[0], mesh, dp)
        h = _fit(shape[2], mesh, "model")
        s = None if h is not None else _fit(shape[1], mesh, "model")
        return stack + (b, s, h, None)
    if name in ("c_kv", "k_rope"):       # [B, S, r]
        return stack + (_fit(shape[0], mesh, dp),
                        _fit(shape[1], mesh, "model"), None)
    if name == "ssm":                    # [B, H, P, N]
        return stack + (_fit(shape[0], mesh, dp),
                        _fit(shape[1], mesh, "model"), None, None)
    if name == "conv":                   # [B, W-1, ch]
        return stack + (_fit(shape[0], mesh, dp), None,
                        _fit(shape[2], mesh, "model"))
    return stack + (None,) * len(shape)  # pos_map and anything else


def cache_pspecs(cfg: ModelConfig, cache: Any, mesh: MeshLike) -> Any:
    """Specs for a decode cache (``init_cache``'s dicts and lists, the same
    structure with a spec at every tensor; host values such as
    ``written`` are kept as they are).  Batch over (pod, data); heads over
    model when they divide, else the sequence (distributed flash-decode:
    the softmax partials are all-reduced)."""
    def walk(node, name=None):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, name) for v in node]
        if isinstance(node, torch.Tensor):
            return _cache_leaf_spec(name, tuple(node.shape), mesh)
        return node
    return walk(cache)


def batch_pspec(mesh: MeshLike) -> Spec:
    return (data_axes(mesh), None)


def placements(spec: Spec, mesh: DeviceMesh) -> List[Placement]:
    """DTensor placements for ``spec`` on ``mesh``: mesh dim i shards the
    tensor dim whose entry names it, else replicates.  Several mesh dims
    may shard one tensor dim (``("pod", "data")``); they must be named in
    mesh order, which is the order DTensor splits them in."""
    names = list(mesh.mesh_dim_names)
    out: List[Placement] = [Replicate() for _ in names]
    for dim, axes in enumerate(spec):
        if axes is None:
            continue
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {axes} of dim {dim} are "
                             f"not in mesh order {tuple(names)}")
        for i in idx:
            out[i] = Shard(dim)
    return out

