"""Fault injection for the serving I/O plane (chaos harness).

The prefetch/offload stack assumes host I/O never fails; this module makes
it fail **on purpose, deterministically**, so the resilience layer can be
exercised in tests and benchmarks the way ``runtime.fault_tolerance``'s
``FailureInjector`` exercises the training supervisor.  A single seeded
:class:`ChaosInjector` is shared by the :class:`~repro_torch.core.offload.
HostExpertStore`, the :class:`~repro_torch.core.cache.ExpertCache` and the
:class:`~repro_torch.core.prefetcher.Prefetcher` and injects four fault classes:

* **transient fetch errors** — ``HostExpertStore.fetch`` raises
  :class:`ChaosError` before touching the staging buffers;
* **latency spikes** — ``fetch`` sleeps ``spike_s`` before returning
  (models a contended PCIe link / an overloaded host);
* **payload corruption** — bytes of the *staged* copy are flipped after the
  gather (the canonical host store is never touched), caught by the
  checksum verification in ``fetch_verified`` / the prefetcher;
* **worker death** — the prefetch worker thread exits on every Nth task
  (the task is handed back to the queue first, so in-flight accounting
  survives; the supervisor restarts the worker).

Determinism: draws come from one seeded ``np.random.Generator`` behind a
lock, so a given seed produces the same fault schedule for the same
sequence of I/O calls.  Two hard bounds make injected faults *survivable by
construction* — losslessness under chaos is a guarantee, not luck:

* ``max_consecutive_faults`` caps back-to-back hard faults, so a bounded
  retry budget can always out-wait an unlucky streak;
* :meth:`ChaosInjector.calm` is a thread-local suppression scope the
  decode-critical retry loop (``OffloadEngine._load_wave``) enters on its
  FINAL attempt: injected faults never exhaust the on-demand path's retry
  budget.  Real (non-injected) failures are unaffected and still surface
  as :class:`ExpertLoadError` → ``finish_reason="io_error"``.

The error taxonomy lives here (not in the prefetcher) because both the
engine facade and the runtime need it without importing each other:

* :class:`ChaosError` — an injected transient I/O fault (an ``IOError``,
  so generic transient-retry handlers cover it);
* :class:`PayloadCorruption` — checksum mismatch on a fetched payload;
* :class:`ExpertLoadError` — the final rung of the degradation ladder:
  an expert could not be loaded even synchronously within the retry
  budget; the owning request finishes with ``finish_reason="io_error"``
  (tokens are never wrong — the request just ends).
"""
from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np


class ChaosError(IOError):
    """An injected transient I/O fault (fetch or insert)."""


class PayloadCorruption(ChaosError):
    """A fetched expert payload failed checksum verification."""


class ExpertLoadError(RuntimeError):
    """An expert could not be loaded even synchronously (retry budget
    exhausted on the on-demand path) — the request finishes with
    ``finish_reason="io_error"`` instead of emitting wrong tokens."""


@dataclass
class ChaosConfig:
    """Seeded fault schedule for the serving I/O plane.  All rates are
    per-call probabilities in [0, 1]; everything defaults to off."""
    seed: int = 0
    fetch_error_rate: float = 0.0     # ChaosError raised from store.fetch
    insert_error_rate: float = 0.0    # ChaosError raised entering cache.insert
    spike_rate: float = 0.0           # latency spike on fetch
    spike_s: float = 0.01             # spike duration (seconds)
    corrupt_rate: float = 0.0         # flip staged payload bytes after fetch
    kill_worker_every: int = 0        # crash the worker on every Nth task (0=never)
    max_consecutive_faults: int = 2   # hard-fault streak bound (see module doc)

    @property
    def enabled(self) -> bool:
        return (self.fetch_error_rate > 0 or self.insert_error_rate > 0
                or self.spike_rate > 0 or self.corrupt_rate > 0
                or self.kill_worker_every > 0)


class ChaosInjector:
    """Deterministic, thread-safe fault source.  One instance is shared by
    the store, the cache and the prefetcher of a chaos-enabled engine; the
    ``injected`` dict is the ground truth tests compare detection counters
    against."""

    def __init__(self, cfg: ChaosConfig):
        self.cfg = cfg
        self._rng = np.random.default_rng(cfg.seed)
        self._lock = threading.Lock()
        self._consecutive = 0          # back-to-back hard faults (bounded)
        self._tasks_seen = 0           # worker-kill schedule position
        self._calm = threading.local() # per-thread suppression depth
        self.injected: Dict[str, int] = {
            "fetch_errors": 0, "insert_errors": 0, "spikes": 0,
            "corruptions": 0, "worker_kills": 0}

    # ------------------------------------------------------------- suppression
    @contextmanager
    def calm(self):
        """Suppress injection on the calling thread (decode-critical final
        attempts).  Reentrant; only injected faults are suppressed."""
        depth = getattr(self._calm, "depth", 0)
        self._calm.depth = depth + 1
        try:
            yield
        finally:
            self._calm.depth = depth

    def _suppressed(self) -> bool:
        return getattr(self._calm, "depth", 0) > 0

    def _hard_fault(self, rate: float) -> bool:
        """One locked draw for a hard (retry-consuming) fault, honouring the
        consecutive-streak bound.  Resets the streak on a clean draw; a
        zero-rate class is NEUTRAL (no draw, no reset) — otherwise a
        disabled fault class would wipe the streak another class just set,
        and the bound would stop bounding."""
        if rate <= 0:
            return False
        with self._lock:
            if self._consecutive < self.cfg.max_consecutive_faults \
                    and self._rng.random() < rate:
                self._consecutive += 1
                return True
            self._consecutive = 0
            return False

    # --------------------------------------------------------------- injection
    def on_fetch(self, n_keys: int) -> None:
        """Called at ``HostExpertStore.fetch`` entry: may sleep (spike) and
        may raise :class:`ChaosError` (transient read failure)."""
        if self._suppressed():
            return
        if self.cfg.spike_rate > 0:
            with self._lock:
                spike = self._rng.random() < self.cfg.spike_rate
            if spike:
                self.injected["spikes"] += 1
                time.sleep(self.cfg.spike_s)      # sleep outside the lock
        if self._hard_fault(self.cfg.fetch_error_rate):
            self.injected["fetch_errors"] += 1
            raise ChaosError(f"injected transient fetch error ({n_keys} keys)")

    def maybe_corrupt(self, arrays: Dict[str, np.ndarray]) -> bool:
        """Called after the staging gather: flip one byte of the first staged
        row (the canonical host store is untouched — only this fetch's copy
        is poisoned, which is exactly what checksum verification must
        catch).  Returns True when a corruption was injected."""
        if self._suppressed() or not arrays:
            return False
        if not self._hard_fault(self.cfg.corrupt_rate):
            return False
        first = next(iter(arrays.values()))
        first[:1].view(np.uint8).reshape(-1)[0] ^= 0xFF
        self.injected["corruptions"] += 1
        return True

    def on_insert(self, n_keys: int) -> None:
        """Called at ``ExpertCache.insert`` entry, BEFORE any bookkeeping
        mutates — a failed insert must leave the cache untouched."""
        if self._suppressed():
            return
        if self._hard_fault(self.cfg.insert_error_rate):
            self.injected["insert_errors"] += 1
            raise ChaosError(f"injected transient insert error ({n_keys} keys)")

    def should_kill_worker(self) -> bool:
        """Deterministic worker-death schedule: True on every Nth prefetch
        task the worker dequeues (never suppressed by ``calm`` — worker
        death is survivable by supervision, not by retries)."""
        if self.cfg.kill_worker_every <= 0:
            return False
        with self._lock:
            self._tasks_seen += 1
            kill = self._tasks_seen % self.cfg.kill_worker_every == 0
        if kill:
            self.injected["worker_kills"] += 1
        return kill
