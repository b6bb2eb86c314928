"""Pipelined prefetch runtime (paper §3.3, Algorithm 2) — supervised.  The
port of ``repro/core/prefetcher.py``: pure Python, unchanged but for its
imports; its inserts go through the port's stream-ordered ``ExpertCache``,
which gives the worker thread its own copy stream on the card.

A dedicated worker thread drains a prefetching task queue and executes
batched loads into the ExpertCache.  Each task carries an "enqueue complete"
event (the cuda.Event analogue — here a threading.Event resolved by the
producer) so the worker never consumes half-prepared task descriptors, and a
"done" event the compute loop can wait on for just-in-time arrival.

In-flight accounting is a counter + condition variable: ``submit`` increments
before enqueueing, the worker decrements after the task is fully executed
(including the cache insert dispatch), and ``drain()`` waits on the condition
— no polling, and no window where a popped-but-still-executing task escapes
the barrier.  The store's double-buffered staging plus the cache's
non-blocking insert mean the worker's H2D transfer for task *i* overlaps the
host gather for task *i+1*.

Two executor flavours mirror the paper's ablation (Figure 8/12):

* ``vanilla``  layer-triggered, synchronous: the producer thread itself loads
               and blocks (I/O serializes with compute).
* ``worker``   continuous background prefetching on the worker thread; with
               ``batched=True`` all experts of a task are loaded in one
               transfer (batched I/O), otherwise one transfer per expert.

Resilience plane (the serving analogue of ``runtime.fault_tolerance``)
----------------------------------------------------------------------
The I/O channel is treated as *fallible in fact*, not just in latency:

* **retry with backoff** — a task's fetch/insert is retried up to
  ``retries`` times with exponential backoff on transient I/O errors
  (:class:`~repro_torch.core.chaos.ChaosError` / ``OSError``), including checksum
  mismatches when ``verify=True`` (corrupt payloads are quarantined — never
  inserted — and refetched);
* **per-task deadlines** — ``task_timeout_s`` stamps each task with a
  deadline; an expired task is failed instead of retried forever;
* **supervised worker** — the worker beats a
  :class:`~repro_torch.runtime.fault_tolerance.Heartbeat` every loop; a dead
  worker (e.g. chaos ``kill_worker_every``) hands its task back to the
  queue before exiting, so ``_inflight`` never strands, and
  :meth:`revive` restarts it (bounded by ``max_worker_restarts``) — once
  the budget is spent, pending tasks are released via
  :meth:`abandon_pending` and the prefetch plane reports unhealthy;
* **circuit breaker** — ``fail_threshold`` consecutive task failures open
  the breaker for ``cooloff_s`` (:meth:`healthy` returns False; the engine
  degrades to on-demand loading) and it half-opens after the cooloff so
  health recovers when the fault clears;
* **bounded waits** — ``drain(timeout=)`` and :meth:`wait_task` return
  False instead of hanging, and both pump :meth:`revive` so a task stuck
  behind a dead worker is restarted or abandoned rather than waited on
  forever;
* **bounded error memory** — failures land in an ``errors`` ring (last
  ``error_ring``) plus a monotonic ``error_count``, surfaced through
  ``OffloadEngine.counters()`` — no unbounded growth, no silent loss.

Every fault path keeps the core invariant: a submitted task's ``done``
event is ALWAYS eventually set (success, failure, timeout or abandonment),
so ``finish_session``'s per-task waits and ``drain`` barriers stay bounded.
"""
from __future__ import annotations

import queue
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional, Sequence

from repro_torch.core.cache import ExpertCache, ExpertKey
from repro_torch.core.chaos import ChaosError, ChaosInjector, PayloadCorruption
from repro_torch.core.offload import HostExpertStore
from repro_torch.runtime.fault_tolerance import Heartbeat

# transient I/O faults worth retrying (ChaosError subclasses IOError/OSError)
TRANSIENT_IO = (OSError,)


@dataclass
class PrefetchTask:
    keys: List[ExpertKey]
    ready: threading.Event                 # producer-side enqueue checkpoint
    done: threading.Event = field(default_factory=threading.Event)
    cancelled: bool = False
    deadline: Optional[float] = None       # monotonic; None = no deadline
    attempts: int = 0                      # execution attempts consumed
    failed: Optional[BaseException] = None # terminal failure, if any
    # per-task I/O attribution (prefetched / evictions /
    # prefetch_evicted_unused), filled by the executing thread; the session
    # that submitted the task folds it at retirement — after done.wait(), so
    # the Event publishes the writes.  This is what keeps per-request I/O
    # ledgers exact when a load lands between two sessions' interleaved
    # turns (it belongs to the task's owner, not to whoever's turn it was).
    stats: Dict[str, int] = field(default_factory=dict)

    def expired(self) -> bool:
        return self.deadline is not None and time.monotonic() > self.deadline


class Prefetcher:
    def __init__(self, store: HostExpertStore, cache: ExpertCache,
                 mode: str = "worker", batched: bool = True, *,
                 retries: int = 3, backoff_s: float = 0.002,
                 task_timeout_s: Optional[float] = None,
                 verify: bool = False,
                 heartbeat_timeout_s: float = 10.0,
                 max_worker_restarts: int = 3,
                 fail_threshold: int = 3, cooloff_s: float = 0.25,
                 error_ring: int = 64,
                 chaos: Optional[ChaosInjector] = None):
        assert mode in ("vanilla", "worker", "off")
        self.store = store
        self.cache = cache
        self.mode = mode
        self.batched = batched
        self.retries = max(0, retries)
        self.backoff_s = backoff_s
        self.task_timeout_s = task_timeout_s
        self.verify = verify
        self.max_worker_restarts = max_worker_restarts
        self.fail_threshold = fail_threshold
        self.cooloff_s = cooloff_s
        self.chaos = chaos
        self.queue: "queue.Queue[Optional[PrefetchTask]]" = queue.Queue()
        self.loaded_count = 0
        self.io_events: List[int] = []     # batch sizes, for kernel-launch accounting
        self._cv = threading.Condition()
        self._inflight = 0                 # submitted but not yet executed
        # bounded error memory: ring of the last ``error_ring`` failures plus
        # a monotonic count (the ring is for debugging, the count for the
        # metrics plane — callers consult counters(), not the ring)
        self.errors: Deque[BaseException] = deque(maxlen=error_ring)
        self.error_count = 0
        self.retry_count = 0
        self.checksum_refetches = 0        # corrupt payloads quarantined+refetched
        self.worker_restarts = 0
        self.worker_deaths = 0
        self.drain_timeouts = 0
        self.refused_submits = 0
        self.abandoned_tasks = 0
        self.consecutive_failures = 0
        self._last_failure_t = 0.0
        self._stopped = False
        self.heartbeat = Heartbeat(host_id=0, timeout_s=heartbeat_timeout_s) \
            if mode == "worker" else None
        self._thread: Optional[threading.Thread] = None
        if mode == "worker":
            self._start_worker()

    # ---------------------------------------------------------------- produce
    def submit(self, keys: Sequence[ExpertKey]) -> Optional[PrefetchTask]:
        """Predictor-side enqueue (Algorithm 1 lines 7-8).  Cached experts are
        skipped by the caller via cache.lookup(touch=False).

        Degradation order when the worker plane is unavailable: a confirmed-
        dead worker is restarted (bounded); past the restart budget — or
        after a clean ``stop()`` — the task executes inline (synchronous
        prefetch); after a ``stop()`` whose join TIMED OUT the worker may
        still be alive and wedged on this very queue/cache, so new submits
        are REFUSED (returns None) rather than raced against it."""
        if self.mode == "off" or not keys:
            return None
        task = PrefetchTask(keys=list(keys), ready=threading.Event())
        if self.task_timeout_s is not None:
            task.deadline = time.monotonic() + self.task_timeout_s
        task.ready.set()                   # descriptor fully prepared
        if self.mode == "vanilla":
            self._run_inline(task)         # synchronous: blocks the producer
            return task
        if self._stopped:
            t = self._thread
            if t is not None and t.is_alive():
                # stop() join timed out: a wedged worker may wake up and
                # race an inline execution on the same queue/cache — refuse
                self.refused_submits += 1
                return None
            self._run_inline(task)         # confirmed dead: degrade inline
            return task
        if not self._ensure_worker():
            # restart budget exhausted: degrade to synchronous execution —
            # enqueueing would bump _inflight with nothing left to
            # decrement it, hanging drain() forever
            self._run_inline(task)
            return task
        with self._cv:
            self._inflight += 1
        self.queue.put(task)
        return task

    # ---------------------------------------------------------------- consume
    def _start_worker(self):
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _ensure_worker(self) -> bool:
        """True iff a live worker is available, restarting a dead one while
        the ``max_worker_restarts`` budget lasts.  Never resurrects a worker
        after ``stop()``."""
        if self.mode != "worker" or self._stopped:
            return False
        t = self._thread
        if t is not None and t.is_alive():
            return True
        if self.worker_restarts >= self.max_worker_restarts:
            return False
        self.worker_restarts += 1
        self._start_worker()
        return True

    def _run(self):
        hb = self.heartbeat
        while True:
            try:
                task = self.queue.get(timeout=0.1)
            except queue.Empty:
                if hb:
                    hb.beat()              # idle liveness
                continue
            if hb:
                hb.beat()
            if task is None:
                self.queue.task_done()
                return
            if self.chaos is not None and self.chaos.should_kill_worker():
                # simulated crash: hand the task back untouched so the
                # in-flight accounting survives the death — the supervisor
                # (revive / _ensure_worker) restarts us and the task is
                # simply executed later, out of order but order-insensitive
                self.worker_deaths += 1
                self.queue.put(task)
                self.queue.task_done()
                return
            try:
                task.ready.wait(timeout=5.0)   # Algorithm 2 line 5
                if not task.cancelled:
                    self._execute_with_retry(task)
            except BaseException as e:     # keep the worker alive: a failed
                self._record_failure(task, e)  # task must not strand the queue
            finally:
                if hb:
                    hb.beat()
                task.done.set()
                self.queue.task_done()
                with self._cv:
                    self._inflight -= 1
                    self._cv.notify_all()

    def _run_inline(self, task: PrefetchTask):
        """Synchronous execution on the producer thread (vanilla mode and
        worker-plane degradation).  Prefetch is best-effort: failures are
        recorded, never raised to the producer — a missed prefetch is
        resolved by the slow path's on-demand loads."""
        try:
            if not task.cancelled:
                self._execute_with_retry(task)
        except BaseException as e:
            self._record_failure(task, e)
        finally:
            task.done.set()

    def _record_failure(self, task: PrefetchTask, e: BaseException):
        task.failed = e
        self.errors.append(e)
        self.error_count += 1
        self.consecutive_failures += 1
        self._last_failure_t = time.monotonic()

    def _execute_with_retry(self, task: PrefetchTask):
        """Bounded retry-with-backoff around ``_execute``: transient I/O
        faults (including checksum mismatches — the corrupt payload is never
        inserted, just refetched) consume the ``retries`` budget; a task
        past its deadline stops retrying immediately.  Success resets the
        circuit-breaker streak."""
        attempts = self.retries + 1
        last: Optional[BaseException] = None
        for a in range(attempts):
            if task.expired():
                raise last if last is not None else \
                    TimeoutError(f"prefetch task deadline expired "
                                 f"({len(task.keys)} keys)")
            task.attempts += 1
            try:
                self._execute(task)
                self.consecutive_failures = 0
                return
            except PayloadCorruption as e:
                self.checksum_refetches += 1
                last = e
            except TRANSIENT_IO as e:
                last = e
            if a < attempts - 1:
                self.retry_count += 1
                time.sleep(self.backoff_s * (2 ** a))
        raise last

    def _fetch(self, keys: Sequence[ExpertKey]):
        if self.verify:
            return self.store.fetch_verified(keys)
        return self.store.fetch(keys)

    def _execute(self, task: PrefetchTask):
        keys = [k for k in task.keys if not self.cache.contains(k)]
        if not keys:
            return
        if self.batched:
            arrays = self._fetch(keys)
            self.cache.insert(keys, arrays,    # one transfer + scatter
                                    stats=task.stats)
            self.io_events.append(len(keys))
        else:
            for k in keys:                            # per-expert sync I/O
                arrays = self._fetch([k])
                self.cache.insert([k], arrays, stats=task.stats)
                self.io_events.append(1)
        self.loaded_count += len(keys)
        task.stats["prefetched"] = task.stats.get("prefetched", 0) + len(keys)

    # ------------------------------------------------------------------ health
    def worker_alive(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def worker_wedged(self) -> bool:
        """A live worker whose heartbeat went stale while work is pending —
        stuck inside a transfer (e.g. a pathological latency spike)."""
        if self.heartbeat is None or not self.worker_alive():
            return False
        with self._cv:
            pending = self._inflight > 0
        return pending and not self.heartbeat.alive()

    def breaker_open(self) -> bool:
        """Circuit breaker: ``fail_threshold`` consecutive task failures
        open it for ``cooloff_s``; it half-opens after the cooloff so a
        cleared fault lets health recover."""
        return (self.consecutive_failures >= self.fail_threshold
                and (time.monotonic() - self._last_failure_t) < self.cooloff_s)

    def healthy(self) -> bool:
        """Is the prefetch plane trustworthy right now?  (Pure probe — use
        :meth:`revive` for the probe-and-repair step.)"""
        if self.mode == "off":
            return True
        if self.breaker_open():
            return False
        if self.mode != "worker":
            return True
        return (not self._stopped and self.worker_alive()
                and not self.worker_wedged())

    def revive(self) -> bool:
        """Probe-and-repair health step (the engine calls this once per
        scheduling round): restarts a dead worker while the budget lasts;
        once the budget is spent, releases any stranded queued tasks so no
        waiter hangs on a task nobody will execute.  Returns overall
        health."""
        if self.mode == "worker" and not self._stopped:
            if not self._ensure_worker():
                self.abandon_pending()
                return False
            if self.worker_wedged():
                return False
        return self.healthy()

    def abandon_pending(self) -> int:
        """Fail every queued (not-yet-executing) task: marks it failed, sets
        ``done`` and releases its in-flight count.  Used when the worker is
        permanently gone — a queued task must never strand its waiters."""
        n = 0
        while True:
            try:
                task = self.queue.get_nowait()
            except queue.Empty:
                return n
            self.queue.task_done()
            if task is None:
                continue
            self._record_failure(
                task, ChaosError("prefetch task abandoned: worker unavailable"))
            task.done.set()
            self.abandoned_tasks += 1
            with self._cv:
                self._inflight -= 1
                self._cv.notify_all()
            n += 1

    def wait_task(self, task: PrefetchTask, timeout: float = 30.0) -> bool:
        """Bounded wait for one task, pumping :meth:`revive` so a task stuck
        behind a dead worker is restarted-or-abandoned instead of waited on
        forever.  True = the task completed (successfully or not)."""
        deadline = time.monotonic() + timeout
        while not task.done.wait(timeout=0.05):
            if time.monotonic() > deadline:
                return False
            if self.mode == "worker" and not self._stopped:
                self.revive()
        return True

    # ------------------------------------------------------------------ admin
    def reset_stats(self):
        """Zero the I/O + error accounting.  Owned here so the engine's
        reset doesn't poke prefetcher internals; in-flight task state and
        the worker-restart BUDGET are untouched (restarts are a lifetime
        bound, not a steady-state stat) — call ``drain()`` first for a
        clean cut."""
        self.loaded_count = 0
        self.io_events = []
        self.error_count = 0
        self.retry_count = 0
        self.checksum_refetches = 0
        self.drain_timeouts = 0
        self.refused_submits = 0
        self.abandoned_tasks = 0

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Block until every submitted task has fully executed and the device
        transfers have landed — or until ``timeout`` (seconds) expires, in
        which case False is returned instead of hanging.  The wait pumps
        :meth:`revive`, so tasks stranded behind a dead worker are restarted
        or abandoned rather than waited on forever."""
        if self.mode == "worker":
            deadline = None if timeout is None \
                else time.monotonic() + timeout
            while True:
                with self._cv:
                    if self._inflight == 0:
                        break
                    self._cv.wait(timeout=0.05)
                    if self._inflight == 0:
                        break
                if not self._stopped:
                    self.revive()
                if deadline is not None and time.monotonic() > deadline:
                    self.drain_timeouts += 1
                    return False
        self.cache.wait()
        return True

    def stop(self, timeout: float = 5.0) -> bool:
        """Shut the worker down.  Returns True when the worker is confirmed
        stopped (pending tasks released); False when the join TIMED OUT —
        the thread handle is KEPT so a later ``stop()`` can try again, and
        ``submit`` refuses new work rather than racing the possibly-still-
        live worker on the queue/cache."""
        self._stopped = True
        t = self._thread
        if t is None:
            return True
        self.queue.put(None)               # poison pill (again, if retried)
        t.join(timeout=timeout)
        if t.is_alive():
            return False                   # keep the handle; submits refused
        self._thread = None
        self.abandon_pending()             # release anything the dead worker
        return True                        # left queued (incl. stale pills)

    def __del__(self):
        try:
            self.stop(timeout=1.0)
        except Exception:
            pass
