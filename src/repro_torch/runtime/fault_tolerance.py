"""Liveness heartbeat (the part of the reference's fault-tolerance module the
supervised prefetch worker uses)."""
from __future__ import annotations

import threading
import time


class Heartbeat:
    """Per-worker liveness: the worker beats once per loop; a supervisor
    checks staleness."""

    def __init__(self, host_id: int, timeout_s: float = 60.0):
        self.host_id = host_id
        self.timeout_s = timeout_s
        self._last = time.monotonic()
        self._lock = threading.Lock()

    def beat(self):
        with self._lock:
            self._last = time.monotonic()

    def alive(self) -> bool:
        with self._lock:
            return (time.monotonic() - self._last) < self.timeout_s
