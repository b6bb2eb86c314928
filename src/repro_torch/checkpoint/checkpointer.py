"""Sharded checkpointing with async save, atomic commit and elastic
restore.  The port of ``repro/checkpoint/checkpointer.py``.

Layout: ``<dir>/step_<n>/{meta.json, <name>.host<k>.npz}``, one npz per
state name (``params``, ``opt``, ``ef``) and host (a rank of the default
process group; one host without one), keyed by the paths of its tensors in
the port's state (a dict's keys, a named tuple's fields, a list's indices,
joined by ``/``).  Each host writes the pieces it owns: a DTensor's local
shard, written by the rank at coordinate 0 on every mesh dim that
replicates it (so each piece once), and a plain tensor whole, by host 0.
``meta.json`` records each tensor's global shape and dtype and each
piece's host, offset and size.

A save copies the host's pieces to the host memory at once, then writes
them on a thread into ``.tmp_step_<n>``; each host's ``meta.host<k>.json``
goes last, and the host that finds every host's there (and wins the
``os.mkdir`` of the commit claim) merges them into ``meta.json``, removes
them and the claim, and renames the directory into place, so a crash
mid-save never corrupts the latest checkpoint and no collective runs
beside the training's own.

``restore`` builds each tensor of ``like`` on the CURRENT layout: a
DTensor's local shard on its mesh (another mesh size or shape than the
writer's: the reference's elastic re-shard), a plain tensor whole, from
the pieces that overlap it, one tensor at a time (no rank gathers the
tree).  bf16 tensors are widened to f32 (exact) and cast back on restore;
int8 and int32 round-trip exactly.  A checkpoint written by the reference
is not meant to load.
"""
from __future__ import annotations

import json
import os
import shutil
import struct
import threading
import zipfile
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset


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


def _at(tree, path: str):
    """The node of ``tree`` at a ``_leaves`` path (None where it has
    none)."""
    for part in path.split("/") if path else ():
        if tree is None:
            return None
        if isinstance(tree, dict):
            tree = tree.get(part)
        elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
            tree = getattr(tree, part, None)
        else:
            tree = tree[int(part)]
    return tree


def _to_host(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.to("cpu", copy=True).numpy()


def _layout(leaf, override=None):
    """(mesh, placements) of a leaf's layout (``override``: a DTensor or a
    ``(mesh, placements)`` pair), or None for a whole tensor."""
    src = override if override is not None else leaf
    if isinstance(src, DTensor):
        return src.device_mesh, tuple(src.placements)
    if isinstance(src, tuple) and len(src) == 2:
        return src[0], tuple(src[1])
    return None


def _box(shape, layout):
    """(offset, size) of this rank's piece of a tensor of ``shape``."""
    if layout is None:
        return (0,) * len(shape), tuple(shape)
    mesh, placements = layout
    size, off = compute_local_shape_and_global_offset(shape, mesh,
                                                      placements)
    return tuple(off), tuple(size)


def _writes(layout, host: int) -> bool:
    """Whether this rank writes its piece: coordinate 0 on every mesh dim
    that replicates it (host 0 for a whole tensor)."""
    if layout is None:
        return host == 0
    mesh, placements = layout
    coord = mesh.get_coordinate()
    return coord is not None and all(
        c == 0 for c, pl in zip(coord, placements)
        if not isinstance(pl, Shard))


def _snapshot(tree, host: int):
    """This host's pieces of ``tree``: ({path: array}, {path: record})."""
    arrays, records = {}, {}
    for path, leaf in _leaves(tree):
        if not isinstance(leaf, torch.Tensor):
            leaf = torch.as_tensor(np.asarray(leaf))
        layout = _layout(leaf)
        if not _writes(layout, host):
            continue
        off, size = _box(tuple(leaf.shape), layout)
        local = leaf.to_local() if isinstance(leaf, DTensor) else leaf
        arrays[path] = _to_host(local)
        records[path] = {"shape": list(leaf.shape),
                         "dtype": str(leaf.dtype).replace("torch.", ""),
                         "offset": list(off), "size": list(size)}
    return arrays, records


def _default_hosts():
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class Checkpointer:
    """``host_id`` defaults to this process's rank; the hosts are the
    default process group's ranks (one host without one).  Host 0 clears
    an earlier run's unfinished saves when it opens the directory (their
    hosts' records would count toward this run's commits); every host
    opens it before the first step, so before any save of this run."""

    def __init__(self, directory: str, keep: int = 3,
                 host_id: Optional[int] = None):
        rank, world = _default_hosts()
        self.dir = directory
        self.keep = keep
        self.host_id = rank if host_id is None else host_id
        self.num_hosts = world
        os.makedirs(directory, exist_ok=True)
        if self.host_id == 0:
            for d in os.listdir(directory):
                if d.startswith(".tmp_step_"):
                    shutil.rmtree(os.path.join(directory, d),
                                  ignore_errors=True)
        self._pending: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------------ save
    def save(self, step: int, state: Dict[str, Any], blocking: bool = False):
        """Async by default: snapshot this host's pieces to the host's
        memory now, write them on a thread (the last host to finish
        commits)."""
        snap = {name: _snapshot(tree, self.host_id)
                for name, tree in state.items()}
        self.wait()

        def _write():
            try:
                tmp = os.path.join(self.dir, f".tmp_step_{step}")
                os.makedirs(tmp, exist_ok=True)
                for name, (arrays, _) in snap.items():
                    np.savez(os.path.join(
                        tmp, f"{name}.host{self.host_id}.npz"), **arrays)
                mine = os.path.join(tmp, f"meta.host{self.host_id}.json")
                with open(mine + ".part", "w") as f:
                    json.dump({n: rec for n, (_, rec) in snap.items()}, f)
                os.replace(mine + ".part", mine)
                self._commit(step, tmp, list(snap))
            except Exception as e:     # re-raised by wait()
                self._error = e

        self._pending = threading.Thread(target=_write, daemon=True)
        self._pending.start()
        if blocking:
            self.wait()

    def _commit(self, step: int, tmp: str, names):
        """Merge the hosts' records into ``meta.json`` and rename ``tmp``
        into place, if every host has written and no other host claimed
        the commit first."""
        metas = [os.path.join(tmp, f"meta.host{k}.json")
                 for k in range(self.num_hosts)]
        if not all(os.path.exists(m) for m in metas):
            return                       # a later host commits
        try:
            os.mkdir(os.path.join(tmp, ".commit"))
        except FileExistsError:
            return
        tensors: Dict[str, Dict[str, Any]] = {n: {} for n in names}
        for k, m in enumerate(metas):
            with open(m) as f:
                for name, recs in json.load(f).items():
                    for path, r in recs.items():
                        t = tensors[name].setdefault(path, {
                            "shape": r["shape"], "dtype": r["dtype"],
                            "pieces": []})
                        t["pieces"].append({"host": k, "offset": r["offset"],
                                            "size": r["size"]})
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump({"step": step, "names": names,
                       "hosts": self.num_hosts, "tensors": tensors}, f)
        for m in metas:                  # every host has written: the
            os.remove(m)                 # step holds meta.json and npzs
        os.rmdir(os.path.join(tmp, ".commit"))
        final = os.path.join(self.dir, f"step_{step}")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

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

    def restore(self, step: int, like: Dict[str, Any],
                shardings: Optional[Dict[str, Any]] = None
                ) -> Dict[str, Any]:
        """The state saved at ``step``, shaped like ``like``: each tensor
        in its model's dtype, on its device and in its layout there (a
        DTensor's local shard on the current mesh, whatever mesh wrote it);
        ``shardings[name]``, a tree like ``like[name]``, may give other
        layouts (a DTensor or a ``(mesh, placements)`` pair at a leaf, None
        to keep ``like``'s)."""
        path = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        out = {}
        for name, tree in like.items():
            files: Dict[int, Any] = {}
            try:
                over = (shardings or {}).get(name)
                built = {p: self._build(meta["tensors"][name][p], p, leaf,
                                        _at(over, p), path, name, files)
                         for p, leaf in _leaves(tree)}
            finally:
                for z in files.values():
                    z.close()
            out[name] = _rebuild(tree, built)
        return out

    @staticmethod
    def _build(rec, key: str, leaf, override, path: str, name: str,
               files):
        """This rank's piece of one saved tensor, from the saved pieces
        that overlap it."""
        shape = tuple(rec["shape"])
        layout = _layout(leaf, override)
        off, size = _box(shape, layout)
        buf, copied = None, 0
        for piece in rec["pieces"]:
            lo = [max(a, b) for a, b in zip(off, piece["offset"])]
            hi = [min(a + n, b + m) for a, n, b, m in
                  zip(off, size, piece["offset"], piece["size"])]
            if any(h <= a for a, h in zip(lo, hi)):
                continue
            host = piece["host"]
            if host not in files:
                files[host] = _Pieces(os.path.join(
                    path, f"{name}.host{host}.npz"))
            arr = files[host][key]
            if buf is None:
                buf = np.empty(size, dtype=arr.dtype)
            src = tuple(slice(a - b, h - b) for a, h, b in
                        zip(lo, hi, piece["offset"]))
            dst = tuple(slice(a - b, h - b) for a, h, b in zip(lo, hi, off))
            buf[dst] = arr[src]
            copied += int(np.prod([h - a for a, h in zip(lo, hi)]))
        # the pieces are disjoint (each written once), so they cover the
        # shard exactly when their overlaps add up to it
        if copied != int(np.prod(size)):
            raise ValueError(
                f"checkpoint {path}: the saved pieces of {name}/{key} cover "
                f"{copied} of the {int(np.prod(size))} elements of the shard "
                f"at offset {list(off)}, size {list(size)}")
        if buf is None:                  # an empty shard
            buf = np.empty(size, dtype=np.float32)
        if not isinstance(leaf, torch.Tensor):
            return buf
        dev = (leaf.to_local() if isinstance(leaf, DTensor) else leaf).device
        # buf is C-ordered already, and a 0-d piece stays 0-d (which
        # np.ascontiguousarray would make 1-d)
        t = torch.from_numpy(buf).to(dev).to(leaf.dtype)
        if layout is None:
            return t
        mesh, placements = layout
        return DTensor.from_local(t, mesh, placements, run_check=False,
                                  shape=torch.Size(shape),
                                  stride=_contiguous_stride(shape))


class _Pieces:
    """One host's npz: each array memory-mapped where it is stored
    uncompressed, as ``np.savez`` stores it (a restore copies only the part
    of a piece its shard needs, straight from the file), else read."""

    def __init__(self, path: str):
        self.path = path
        self.zip = zipfile.ZipFile(path)

    def __getitem__(self, key: str) -> np.ndarray:
        info = self.zip.getinfo(key + ".npy")
        if info.compress_type == zipfile.ZIP_STORED:
            with open(self.path, "rb") as f:
                f.seek(info.header_offset + 26)   # the local file header
                name_len, extra_len = struct.unpack("<HH", f.read(4))
                f.seek(info.header_offset + 30 + name_len + extra_len)
                version = np.lib.format.read_magic(f)
                read = {(1, 0): np.lib.format.read_array_header_1_0,
                        (2, 0): np.lib.format.read_array_header_2_0}
                if version in read:
                    shape, fortran, dtype = read[version](f)
                    if shape and min(shape) > 0 and not dtype.hasobject:
                        return np.memmap(self.path, dtype=dtype, mode="r",
                                         offset=f.tell(), shape=shape,
                                         order="F" if fortran else "C")
        with self.zip.open(info) as f:
            return np.lib.format.read_array(f)

    def close(self):
        self.zip.close()


def _contiguous_stride(shape):
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def _rebuild(like, built: Dict[str, Any], prefix=""):
    """A tree shaped like ``like`` with its leaves from ``built``."""
    if isinstance(like, dict):
        return {k: _rebuild(v, built, f"{prefix}{k}/")
                for k, v in like.items()}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_rebuild(getattr(like, k), built,
                                     f"{prefix}{k}/")
                            for k in like._fields))
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, built, f"{prefix}{i}/")
                          for i, v in enumerate(like))
    return built[prefix[:-1]]
