"""Checkpointing with async save and atomic commit.  The port of
``repro/checkpoint/checkpointer.py``.

Layout: ``<dir>/step_<n>/{meta.json, <name>.host<k>.npz}``, one npz per
state name (``params``, ``opt``, ``ef``), keyed by the paths of its tensors
in the port's state (a dict's keys, a named tuple's fields, a list's
indices, joined by ``/``).  A save copies the state to the host at once,
then writes it on a thread, into a temp directory renamed into place, so a
crash mid-save never corrupts the latest checkpoint.  bf16 tensors are
widened to f32 (exact) and cast back on restore; int8 and int32 round-trip
exactly.  Trimmed: the reference's restore onto other shardings (one device
here); a checkpoint written by the reference is not meant to load.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch


def _leaves(tree, prefix=""):
    """(path, leaf) pairs in a fixed order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}/")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k in tree._fields:
            yield from _leaves(getattr(tree, k), f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def _to_host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.to("cpu", copy=True).numpy()
    return np.asarray(leaf)


def _flatten(tree) -> Dict[str, np.ndarray]:
    """Host snapshot of every leaf."""
    return {key: _to_host(leaf) for key, leaf in _leaves(tree)}


def _unflatten_into(like, flat: Dict[str, np.ndarray], prefix=""):
    """A tree shaped like ``like`` with its leaves from ``flat``: a tensor
    takes its model's dtype and device, anything else is an array."""
    if isinstance(like, dict):
        return {k: _unflatten_into(v, flat, f"{prefix}{k}/")
                for k, v in like.items()}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_unflatten_into(getattr(like, k), flat,
                                            f"{prefix}{k}/")
                            for k in like._fields))
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten_into(v, flat, f"{prefix}{i}/")
                          for i, v in enumerate(like))
    arr = flat[prefix[:-1]]
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(np.ascontiguousarray(arr)).to(
            dtype=like.dtype, device=like.device)
    return arr


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3, host_id: int = 0):
        self.dir = directory
        self.keep = keep
        self.host_id = host_id
        os.makedirs(directory, exist_ok=True)
        self._pending: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------------ save
    def save(self, step: int, state: Dict[str, Any], blocking: bool = False):
        """Async by default: snapshot to host now, write on a thread."""
        flat = {name: _flatten(tree) for name, tree in state.items()}
        self.wait()

        def _write():
            try:
                tmp = os.path.join(self.dir,
                                   f".tmp_step_{step}_{self.host_id}")
                final = os.path.join(self.dir, f"step_{step}")
                os.makedirs(tmp, exist_ok=True)
                for name, tree in flat.items():
                    np.savez(os.path.join(
                        tmp, f"{name}.host{self.host_id}.npz"), **tree)
                with open(os.path.join(tmp, "meta.json"), "w") as f:
                    json.dump({"step": step, "names": list(flat.keys())}, f)
                if os.path.exists(final):
                    shutil.rmtree(final)
                os.rename(tmp, final)
                self._gc()
            except Exception as e:     # re-raised by wait()
                self._error = e

        self._pending = threading.Thread(target=_write, daemon=True)
        self._pending.start()
        if blocking:
            self.wait()

    def wait(self):
        """Wait for the pending save; raise what it raised."""
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("checkpoint save failed") from err

    def _gc(self):
        steps = sorted(self.steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    # --------------------------------------------------------------- restore
    def steps(self):
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_"):
                out.append(int(d.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, step: int, like: Dict[str, Any]) -> Dict[str, Any]:
        """The state saved at ``step``, shaped like ``like`` (each tensor on
        its model's device, in its model's dtype)."""
        path = os.path.join(self.dir, f"step_{step}")
        out = {}
        for name, tree in like.items():
            with np.load(os.path.join(
                    path, f"{name}.host{self.host_id}.npz")) as z:
                flat = {k: z[k] for k in z.files}
            out[name] = _unflatten_into(tree, flat)
        return out
