"""Carry weights across from the reference: a JAX param tree (numpy leaves,
as from ``jax.tree.map(np.asarray, params)``) into the port's modules.

Leaves of the stacked ``layers`` subtree have a leading ``[L, ...]`` axis,
which is unstacked into ``layers.<l>.<path>``.  bf16 leaves (numpy dtype
name ``bfloat16``) are read through a ``uint16`` view, so nothing of JAX is
imported here.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def _tensor(a: Any) -> torch.Tensor:
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _flatten(tree: Mapping[str, Any], prefix: str = ""):
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, Mapping):
            yield from _flatten(v, name + ".")
        else:
            yield name, v


def params_from_jax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Reference param tree -> the port's state dict (CPU tensors)."""
    state: Dict[str, torch.Tensor] = {}
    for name, leaf in _flatten(tree):
        if name.startswith("layers."):
            rest = name[len("layers."):]
            t = _tensor(leaf)
            for l in range(t.shape[0]):
                state[f"layers.{l}.{rest}"] = t[l].clone()
        else:
            state[name] = _tensor(leaf)
    return state


def load_jax_params(model: torch.nn.Module, tree: Mapping[str, Any]):
    """Copy a reference param tree into ``model`` (every name must match)."""
    model.load_state_dict(params_from_jax(tree), strict=True)
    return model
