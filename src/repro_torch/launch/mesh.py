"""Mesh construction on ``torch.distributed``.  The port of
``repro/launch/mesh.py``.

Every mesh is made by a FUNCTION (never a module-level constant), so
importing this module touches no process-group state.  The shapes and axis
names are the reference's, so every dry-run cell compares one to one:
``(16, 16)`` as ``("data", "model")``, ``(2, 16, 16)`` as ``("pod",
"data", "model")``.  A mesh needs the default process group to be up with
a world size equal to the mesh's size; the device type is the card's
(``"cuda"``) unless the caller asks for ``"cpu"``.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def _make_mesh(shape: Sequence[int], axes: Sequence[str],
               device_type: str) -> DeviceMesh:
    size = int(np.prod(shape))
    world = dist.get_world_size() if dist.is_initialized() else 1
    if size != world:
        raise ValueError(f"a mesh of shape {tuple(shape)} needs {size} "
                         f"ranks; the default process group has {world}")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """16x16 single pod (256 ranks) or 2x16x16 multi-pod (512 ranks)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _make_mesh(shape, axes, device_type)


def make_mesh_from_plan(plan: Dict[str, int],
                        device_type: str = "cuda") -> DeviceMesh:
    """Mesh from an elastic re-plan (runtime/fault_tolerance.plan_mesh)."""
    axes = tuple(a for a in ("pod", "data", "model") if a in plan)
    return _make_mesh(tuple(plan[a] for a in axes), axes, device_type)


def single_device_mesh(device_type: str = "cuda") -> DeviceMesh:
    return _make_mesh((1, 1), ("data", "model"), device_type)
