"""Carry weights across from the reference: a JAX param tree (numpy leaves,
as from ``jax.tree.map(np.asarray, params)``) into the port's modules.

The reference stacks layers of one structure along leading axes, which are
unstacked here: ``layers``, ``dense_layers``, ``tail`` and an encdec
model's ``enc`` / ``dec`` are ``[L, ...]`` and become
``layers.<l>.<path>``, ``dense_layers.<l>.<path>``, ``tail.<t>.<path>``,
``enc.<l>.<path>`` and ``dec.<l>.<path>``; a hybrid model's
``mamba_groups`` is ``[G, per, ...]`` and becomes
``mamba_groups.<g>.<i>.<path>``.  Any other subtree
(``shared_attn``, one block whose weights every group reuses) keeps its
path.  bf16 leaves (numpy dtype name ``bfloat16``) are read through a
``uint16`` view, so nothing of JAX is imported here.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping

import numpy as np
import torch

# top-level subtree -> number of stacked leading axes
STACKED = {"layers": 1, "dense_layers": 1, "tail": 1, "mamba_groups": 2,
           "enc": 1, "dec": 1}


def stack_groups(params: Mapping[str, torch.Tensor], block: int
                 ) -> Dict[str, List[str]]:
    """The reference's stacked leaves whose ``block``-element blocks (of
    the flattened leaf) straddle the port's per-layer tensors: ``{group
    key: member names}``, the members in the order the reference flattens
    its stack (row-major over the stacked axes of ``STACKED``:
    ``mamba_groups.<g>.<i>`` runs over i inside g).  The key puts ``*``
    for each stacked index (``layers.*.mamba.A_log``), so no parameter has
    it.  A stack whose layer tensors are a whole number of blocks each
    (every weight matrix at 256), or that has one layer, is not a group:
    its layers' own blocks are the stack's."""
    stacks: Dict[str, list] = {}
    for name, p in params.items():
        top, _, rest = name.partition(".")
        depth = STACKED.get(top, 0)
        parts = rest.split(".")
        if not depth or len(parts) <= depth or \
                not all(i.isdigit() for i in parts[:depth]):
            continue
        key = ".".join([top] + ["*"] * depth + parts[depth:])
        stacks.setdefault(key, []).append(
            (tuple(int(i) for i in parts[:depth]), name, p.numel()))
    return {key: [n for _, n, _ in sorted(members)]
            for key, members in stacks.items()
            if len(members) > 1 and members[0][2] % block}


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
