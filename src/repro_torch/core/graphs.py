"""Captured decode steps: the port of the reference's compiled steps
(``repro/core/runtime.py``: the ``jax.jit`` wrappers of ``_build_jitted``
and ``_precompile_fast``; ``repro/core/sd.py``: ``make_greedy_step`` and
the jitted SD iteration).

The reference compiles a decode step into one device program per shape and
launches it with one host dispatch.  The port's counterpart is a CUDA
graph: a step's body (plain PyTorch calls and the hand-written kernels) is
captured once per key and then replayed with one launch, its inputs copied
into static buffers first.  ``GraphSet`` holds the keyed steps and counts
their builds per kind (the reference's ``_fast_traces`` /
``_batched_traces``).

A body's contract:

* its inputs are the tensors (or host ints, kept as 0-d int32 tensors)
  handed to ``run``; everything else it touches (weights, KV caches, the
  expert slot pool, a session's history) lives at an address that never
  changes while the graph exists: the caches come from a ``SessionPool``;
* it may write the caches in place only where running it twice on the same
  inputs leaves them as running it once (a decode block rewrites the slots
  of its own positions), because a build runs it once eagerly (the warm-up)
  before the capture and the first call replays it;
* what it returns is valid until the next ``run`` of the same key: a
  caller keeps an output past that by copying it.

On the card a build warms the body up on a side stream (lazy library and
kernel set-up happen outside the capture), then captures it on that stream
into a private memory pool of its own, in ``thread_local`` capture mode:
the prefetch worker may allocate, copy and record events on its own stream
while the decode thread captures.  A capture that fails raises; nothing
falls back to running eagerly.  The kernel wrappers count only the launches
they make: the warm-up's and the eager calls'.  A call inside a capture
records its kernel into the graph and launches nothing, and a replay calls
no wrapper, so a replay's kernels are seen only on the device (a profiler
trace).

On the CPU there are no graphs: ``run`` copies the inputs into the same
static buffers and calls the body on them, so the tests hold the static
body to the eager one.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
from typing import Any, Callable, Dict, Hashable, List, Optional, Sequence

import torch


class StepGraph:
    """One keyed step: static inputs, the body, and on the card its
    captured ``torch.cuda.CUDAGraph`` with the outputs it fills."""

    def __init__(self, body: Callable, inputs: Sequence[Any],
                 device: torch.device,
                 stream: Optional["torch.cuda.Stream"] = None):
        self.body = body
        self.statics = [
            torch.tensor(x, dtype=torch.int32, device=device)
            if isinstance(x, int) else x.detach().clone() for x in inputs]
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.outputs: Any = None
        self.pool_bytes = 0
        if device.type == "cuda":
            self._capture(device, stream)

    def _capture(self, device: torch.device, side: "torch.cuda.Stream"):
        cur = torch.cuda.current_stream(device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            self.body(*self.statics)                 # warm-up, eager
            graph = torch.cuda.CUDAGraph()
            reserved = torch.cuda.memory_reserved(device)
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                outputs = self.body(*self.statics)
            except BaseException:
                with contextlib.suppress(RuntimeError):
                    graph.capture_end()
                raise
            graph.capture_end()
            self.pool_bytes = torch.cuda.memory_reserved(device) - reserved
        cur.wait_stream(side)
        self.graph, self.outputs = graph, outputs

    def __call__(self, *inputs):
        for s, x in zip(self.statics, inputs):
            if isinstance(x, int):
                s.fill_(x)
            else:
                s.copy_(x)
        if self.graph is None:
            return self.body(*self.statics)
        self.graph.replay()
        return self.outputs


class GraphSet:
    """Keyed step graphs on one device.  A key is a tuple whose first item
    names the kind of step; ``builds`` and ``runs`` count per kind,
    ``key_runs`` per key, ``capture_s`` sums the builds' wall time
    (warm-up included)."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self._graphs: Dict[Hashable, StepGraph] = {}
        self.builds: "collections.Counter[str]" = collections.Counter()
        self.runs: "collections.Counter[str]" = collections.Counter()
        self.key_runs: "collections.Counter[Hashable]" = \
            collections.Counter()
        self.capture_s = 0.0
        self._stream = None

    def __contains__(self, key) -> bool:
        return key in self._graphs

    def build(self, key: tuple, body: Callable, inputs: Sequence[Any]
              ) -> StepGraph:
        """Build ``key``'s step from ``body`` and example ``inputs`` (their
        values are the warm-up's)."""
        if key in self._graphs:
            raise ValueError(f"step {key} is already built")
        if self.device.type == "cuda" and self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        t0 = time.perf_counter()
        g = StepGraph(body, inputs, self.device, self._stream)
        self.capture_s += time.perf_counter() - t0
        self._graphs[key] = g
        self.builds[key[0]] += 1
        return g

    def run(self, key: tuple, body: Callable, *inputs):
        """Run ``key``'s step on ``inputs``, building it from ``body`` on
        first use."""
        g = self._graphs.get(key)
        if g is None:
            g = self.build(key, body, inputs)
        self.runs[key[0]] += 1
        self.key_runs[key] += 1
        return g(*inputs)

    def pool_bytes(self) -> Dict[Hashable, int]:
        """Device bytes each captured step's private memory pool took."""
        return {k: g.pool_bytes for k, g in self._graphs.items()}


@dataclasses.dataclass
class SessionSlot:
    """Per-session device state that outlives a request, so that a
    captured step's addresses stay valid: the target's KV (or MLA) cache,
    the draft's, and (offload runtime) the MoE-Infinity history."""
    index: int
    tcache: Any
    dcache: Any = None
    history: Optional[torch.Tensor] = None


class SessionPool:
    """Slots of per-session state: a session takes the lowest free one and
    gives it back when it ends.  The pool grows to the concurrency served
    and never shrinks.  A new slot holds ``target``'s cache and, where there
    is a draft, the draft's, both of ``max_seq`` positions, and a zero
    history of ``history_shape`` where that is given."""

    def __init__(self, target, draft=None, max_seq: int = 0,
                 history_shape: Optional[Sequence[int]] = None):
        self._target, self._draft = target, draft
        self._max_seq, self._history_shape = max_seq, history_shape
        self.slots: List[SessionSlot] = []
        self._free: List[int] = []

    def take(self) -> SessionSlot:
        if self._free:
            self._free.sort()
            return self.slots[self._free.pop(0)]
        t, d, n = self._target, self._draft, self._max_seq
        slot = SessionSlot(
            len(self.slots), tcache=t.init_cache(1, n),
            dcache=d.init_cache(1, n) if d is not None else None,
            history=None if self._history_shape is None else torch.zeros(
                tuple(self._history_shape), dtype=torch.float32,
                device=t.device))
        self.slots.append(slot)
        return slot

    def give(self, slot: SessionSlot):
        if slot.index in self._free or self.slots[slot.index] is not slot:
            raise ValueError(f"slot {slot.index} is not taken from this pool")
        self._free.append(slot.index)

    @property
    def in_use(self) -> int:
        return len(self.slots) - len(self._free)
