"""Carry weights across from the reference: a JAX param tree (numpy leaves,
as from ``jax.tree.map(np.asarray, params)``) into the port's modules.

The reference stacks layers of one structure along leading axes, which are
unstacked here: ``layers``, ``dense_layers`` and ``tail`` are ``[L, ...]``
and become ``layers.<l>.<path>``, ``dense_layers.<l>.<path>`` and
``tail.<t>.<path>``; a hybrid model's
``mamba_groups`` is ``[G, per, ...]`` and becomes
``mamba_groups.<g>.<i>.<path>``.  Any other subtree
(``shared_attn``, one block whose weights every group reuses) keeps its
path.  bf16 leaves (numpy dtype name ``bfloat16``) are read through a
``uint16`` view, so nothing of JAX is imported here.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

# top-level subtree -> number of stacked leading axes
STACKED = {"layers": 1, "dense_layers": 1, "tail": 1, "mamba_groups": 2}


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
        top, _, rest = name.partition(".")
        depth = STACKED.get(top, 0)
        t = _tensor(leaf)
        if not depth:
            state[name] = t
            continue
        for idx in np.ndindex(*t.shape[:depth]):
            at = ".".join(str(i) for i in idx)
            state[f"{top}.{at}.{rest}"] = t[idx].clone()
    return state


def load_jax_params(model: torch.nn.Module, tree: Mapping[str, Any]):
    """Copy a reference param tree into ``model`` (every name must match).
    The reference draws an expert gate projection ``moe.wg`` for every
    expert activation (``init_moe``) but only swiglu experts read it; the
    port builds none for gelu experts, so it is not copied there."""
    state = params_from_jax(tree)
    cfg = getattr(model, "cfg", None)
    if cfg is not None and cfg.is_moe and cfg.ffn_activation != "swiglu":
        state = {n: t for n, t in state.items()
                 if not n.endswith(".moe.wg")}
    model.load_state_dict(state, strict=True)
    return model
