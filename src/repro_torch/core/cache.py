"""Device-side expert cache with LRU eviction (paper §3.3 / §4.4).  The port
of ``repro/core/cache.py``.

A fixed pool of ``num_slots`` expert-weight buffers lives in device memory
(``bufs[name]: [S, ...]``), with host-side bookkeeping:

* ``table``  ExpertKey -> slot (the page table)
* ``lru``    access order (OrderedDict; head = eviction candidate)

and, when constructed with ``table_shape=(L, E)``, a device mirror of the
page table, ``table_dev [L, E] int32 -> slot | -1``, which the verify fast
path gathers from so routing never leaves the device.

Stream ordering (on the card).  The reference leans on XLA to sequence its
donated buffer updates after pending readers; here the order is explicit:

* ``insert`` writes the slots and ``table_dev`` in place on a copy stream of
  the calling thread (the prefetch worker and the decode loop each get their
  own ``torch.cuda.Stream``).  Before writing, that stream waits on the event
  recorded on the compute stream when the last reader released the pool
  (``reading()``) — an evicted slot is never overwritten under a kernel still
  reading it — and on the previous insert's event, so two threads' inserts
  land in the order their bookkeeping was made.
* ``reading()`` makes the compute stream wait on the last insert's event
  before it yields the pool, so host bookkeeping may call a key a hit as
  soon as ``insert`` returns, before its bytes have landed.
* An insert's copies read the host store's pinned staging buffer; the event
  recorded after them is handed back to that buffer (``release``), and the
  store waits on it before it refills the buffer.

On the CPU everything runs in program order and no streams exist.
"""
from __future__ import annotations

import contextlib
import threading
from collections import OrderedDict
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

ExpertKey = Tuple[int, int]   # (layer, expert)


def host_to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """Small host array -> device tensor without a host sync: through pinned
    memory and a non-blocking copy on the card."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


class ExpertCache:
    """LRU cache of expert weights in device memory (the card unless
    ``device="cpu"``; it raises without one).  Thread-safe: the prefetch
    worker and the decode loop both mutate it."""

    def __init__(self, num_slots: int, buffer_shapes: Dict[str, tuple],
                 dtype: torch.dtype = torch.bfloat16,
                 table_shape: Optional[Tuple[int, int]] = None,
                 chaos=None, device: DeviceLike = None):
        self.num_slots = num_slots
        self.dtype = dtype
        self.device = resolve_device(device)
        self._cuda = self.device.type == "cuda"
        # optional fault injector (core/chaos.py): inserts may raise an
        # injected transient error BEFORE any bookkeeping mutates
        self.chaos = chaos
        self.bufs = {name: torch.zeros((num_slots,) + tuple(shape),
                                       dtype=dtype, device=self.device)
                     for name, shape in buffer_shapes.items()}
        self.table: Dict[ExpertKey, int] = {}
        self.lru: "OrderedDict[ExpertKey, int]" = OrderedDict()
        self.free: List[int] = list(range(num_slots))
        self.lock = threading.RLock()
        self.table_shape = table_shape
        self.table_dev: Optional[torch.Tensor] = (
            torch.full(table_shape, -1, dtype=torch.int32, device=self.device)
            if table_shape is not None else None)
        # stream ordering (card only)
        self._tls = threading.local()       # each thread's copy stream
        self._last_insert = None            # event after the newest insert
        self._readers_done = None           # event after the newest reader
        # stats
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.prefetch_evicted = 0   # evicted before ever being used

    # ------------------------------------------------------------------ reads
    def contains(self, key: ExpertKey) -> bool:
        with self.lock:
            return key in self.table

    def lookup(self, keys: Sequence[ExpertKey], touch: bool = True
               ) -> Tuple[Dict[ExpertKey, int], List[ExpertKey]]:
        """Split into (hits: key->slot, misses).  Updates LRU + stats."""
        with self.lock:
            hits, misses = {}, []
            for k in keys:
                if k in self.table:
                    hits[k] = self.table[k]
                    self.hits += 1
                    if touch:
                        self.lru.move_to_end(k)
                        self.lru[k] = 1    # mark used
                else:
                    misses.append(k)
                    self.misses += 1
            return hits, misses

    @contextlib.contextmanager
    def reading(self) -> Iterator[Tuple[Dict[str, torch.Tensor],
                                        Optional[torch.Tensor]]]:
        """Hold the pool for a reader: yields (bufs, table_dev) under the
        lock, with the current stream ordered after every insert so far.
        Dispatch the kernels that read the pool inside the block; on exit an
        event on the current stream marks them, and later inserts wait on
        it before they overwrite a slot."""
        with self.lock:
            if self._cuda and self._last_insert is not None:
                torch.cuda.current_stream(self.device).wait_event(
                    self._last_insert)
            try:
                yield self.bufs, self.table_dev
            finally:
                if self._cuda:
                    ev = torch.cuda.Event()
                    ev.record(torch.cuda.current_stream(self.device))
                    self._readers_done = ev

    # ----------------------------------------------------------------- writes
    def _allocate(self, n: int, protect: frozenset = frozenset()
                  ) -> Tuple[List[int], List[ExpertKey]]:
        """Reserve n slots, evicting LRU entries as needed.  Lock held.
        Keys in ``protect`` (the insert batch's already-present members) are
        never chosen as victims.  Returns (slots, evicted)."""
        slots: List[int] = []
        evicted: List[ExpertKey] = []
        while len(slots) < n:
            if self.free:
                slots.append(self.free.pop())
                continue
            victim = next((k for k in self.lru if k not in protect), None)
            if victim is None:
                raise ValueError(
                    f"batch needs {n} slots but cache capacity is "
                    f"{self.num_slots}; load in waves "
                    f"(see runtime._verify_block_slow)")
            used = self.lru.pop(victim)
            slots.append(self.table.pop(victim))
            evicted.append(victim)
            self.evictions += 1
            if not used:
                self.prefetch_evicted += 1
        return slots, evicted

    def _copy_stream(self):
        s = getattr(self._tls, "stream", None)
        if s is None:
            s = torch.cuda.Stream(self.device)
            self._tls.stream = s
        return s

    def insert(self, keys: Sequence[ExpertKey],
               host_arrays: Dict[str, torch.Tensor],
               mark_used: bool = False,
               stats: Optional[Dict[str, int]] = None) -> List[int]:
        """Batched I/O (paper §3.3): one H2D copy per (expert, tensor)
        straight into its slot, plus one ``table_dev`` scatter, for the whole
        group.  host_arrays: name -> [n, ...] host tensors (pinned staging on
        the card).  Asynchronous on the card (see the module docstring);
        ``wait()`` is the hard barrier.

        ``stats`` (optional) is credited with this call's ``evictions`` /
        ``prefetch_evicted_unused`` (per-session I/O attribution)."""
        if not keys:
            return []
        if self.chaos is not None:
            # injected transient insert failure, raised before the lock and
            # before ANY bookkeeping — a failed insert leaves the cache as it
            # was, so the caller's retry is safe
            self.chaos.on_insert(len(keys))
        with self.lock:
            if len(set(keys)) > self.num_slots:
                raise ValueError(
                    f"batch of {len(set(keys))} experts exceeds cache "
                    f"capacity {self.num_slots}; load in waves "
                    f"(see runtime._verify_block_slow)")
            # dedupe (first occurrence wins) — a duplicated key must not
            # allocate two slots, that would leak one permanently
            seen = set()
            fresh: List[ExpertKey] = []
            sel: List[int] = []
            for i, k in enumerate(keys):
                if k not in self.table and k not in seen:
                    fresh.append(k)
                    sel.append(i)
                    seen.add(k)
            if fresh:
                ev0, pu0 = self.evictions, self.prefetch_evicted
                slots, evicted = self._allocate(
                    len(fresh), protect=frozenset(keys))
                if stats is not None:        # lock held: counters consistent
                    stats["evictions"] = stats.get("evictions", 0) + \
                        self.evictions - ev0
                    stats["prefetch_evicted_unused"] = \
                        stats.get("prefetch_evicted_unused", 0) + \
                        self.prefetch_evicted - pu0
                self._write(host_arrays, sel, slots, evicted, fresh)
                for k, s in zip(fresh, slots):
                    self.table[k] = s
                    self.lru[k] = 1 if mark_used else 0
                    self.lru.move_to_end(k)
            # refresh LRU position of already-present keys
            for k in keys:
                if k in self.lru:
                    self.lru.move_to_end(k)
            return [self.table[k] for k in keys]

    def _write(self, host_arrays, sel, slots, evicted, fresh):
        """Copy the fresh rows into their slots and update ``table_dev``.
        Lock held."""
        ls = [k[0] for k in evicted + fresh]
        es = [k[1] for k in evicted + fresh]
        vals = [-1] * len(evicted) + slots
        idx = np.asarray([ls, es, vals], np.int64)
        ctx = contextlib.nullcontext()
        if self._cuda:
            stream = self._copy_stream()
            if self._readers_done is not None:
                stream.wait_event(self._readers_done)   # eviction hazard
            if self._last_insert is not None:
                stream.wait_event(self._last_insert)    # inserts in order
            ctx = torch.cuda.stream(stream)
        with ctx:
            for name, buf in self.bufs.items():
                src = host_arrays[name]
                for i, s in zip(sel, slots):
                    buf[s].copy_(src[i], non_blocking=True)
            if self.table_dev is not None:
                t = host_to_device(idx, self.device)
                self.table_dev[t[0], t[1]] = t[2].to(torch.int32)
            if self._cuda:
                ev = torch.cuda.Event()
                ev.record(stream)
                self._last_insert = ev
                release = getattr(host_arrays, "release", None)
                if release is not None:
                    release(ev)

    def wait(self):
        """Barrier: every dispatched buffer update has landed."""
        with self.lock:
            ev = self._last_insert
        if ev is not None:
            ev.synchronize()

    # ------------------------------------------------------------------ stats
    def reset_stats(self):
        with self.lock:
            self.hits = self.misses = self.evictions = self.prefetch_evicted = 0

    def check_invariants(self) -> bool:
        """Page table and LRU agree, no slot aliasing, and the device table
        mirror matches the host page table exactly (reads the mirror back)."""
        with self.lock:
            if set(self.table.keys()) != set(self.lru.keys()):
                return False
            slots = list(self.table.values())
            if len(slots) != len(set(slots)):
                return False
            if any(s < 0 or s >= self.num_slots for s in slots):
                return False
            if set(slots) & set(self.free):
                return False
            if len(slots) + len(self.free) != self.num_slots:
                return False
            if self.table_dev is not None:
                self.wait()
                tdev = self.table_dev.cpu().numpy()
                want = np.full(self.table_shape, -1, np.int32)
                for (l, e), s in self.table.items():
                    want[l, e] = s
                if not np.array_equal(tdev, want):
                    return False
            return True
