"""Host-resident expert store (the offloaded side of the cache).  The port of
``repro/core/offload.py``.

The canonical copy of every routed expert stays in host memory for the
engine's lifetime (eviction never copies back, paper §7), as plain pageable
tensors ``[L·E, ...]`` — at full mixtral width and 4 layers that is
11.3 GB, more than is wise to pin.  Only the staging ring is pinned: ``fetch``
gathers a batch into a preallocated pinned buffer (one ``index_select`` per
weight tensor), from which ``ExpertCache.insert`` copies to the device
without blocking.  Per thread, two staging buffers alternate (double
buffering), each sized to the largest batch that thread has fetched.

Staging reuse: a staged batch's H2D copies may still be running when the
thread fetches again, so each buffer carries the event its last copies
recorded (``StagedBatch.release``) and ``fetch`` waits on it before it
refills the buffer.

Payload integrity: every (layer, expert) has a lazily memoised CRC32 over
its weight tensors; ``fetch_verified`` re-checksums the STAGED copy and
raises :class:`~repro_torch.core.chaos.PayloadCorruption` on mismatch, so a
corrupted transfer never reaches the device cache.
"""
from __future__ import annotations

import threading
import zlib
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.cache import ExpertKey
from repro_torch.core.chaos import ChaosInjector, PayloadCorruption

_NUM_STAGING = 2          # double buffer: gather batch i+1 while i transfers


class _Stage:
    """One staging buffer: name -> [cap, ...] host tensors, and the event of
    the last copies that read it."""

    def __init__(self, tensors: Dict[str, torch.Tensor]):
        self.tensors = tensors
        self.event = None


class StagedBatch(dict):
    """name -> [n, ...] views into a staging buffer.  The cache calls
    ``release(event)`` with the event that follows its copies out of it."""

    def __init__(self, stage: _Stage, n: int):
        super().__init__({k: t[:n] for k, t in stage.tensors.items()})
        self._stage = stage

    def release(self, event):
        self._stage.event = event


def _bytes(t: torch.Tensor) -> np.ndarray:
    """Raw bytes of a contiguous host tensor (bf16 included) for CRC32."""
    t = t.contiguous()
    return t.view(torch.uint8).numpy() if t.dim() else t.numpy()


class HostExpertStore:
    """Copies a target model's routed experts to host memory and serves
    batched reads of them."""

    def __init__(self, cfg: ModelConfig, model, staging_batch: int = 2,
                 chaos: Optional[ChaosInjector] = None,
                 pin: bool = False):
        assert cfg.is_moe, "HostExpertStore requires an MoE config"
        self.cfg = cfg
        moes = [blk.moe for blk in model.layers if blk.kind == "moe"]
        self.names = [n for n in ("wg", "wu", "wd") if hasattr(moes[0], n)]
        self.num_layers = len(moes)
        self.num_experts = moes[0].wu.shape[0]
        # canonical flat [L*E, ...] copies in pageable host memory
        self._flat = {n: torch.cat([getattr(m, n).detach().to("cpu")
                                    for m in moes]).contiguous()
                      for n in self.names}
        self.pin = pin                      # pinned staging (card only)
        self._stage_batch = max(1, staging_batch)
        self._tls = threading.local()
        self._pinned_lock = threading.Lock()
        self.pinned_bytes = 0               # staging memory pinned so far
        self.chaos = chaos
        self.checksum_failures = 0          # staged payloads that failed CRC
        self._sums: Dict[ExpertKey, int] = {}   # canonical CRC32 per key
        self._sums_lock = threading.Lock()

    def _alloc_stage(self, cap: int) -> _Stage:
        out = {n: torch.empty((cap,) + tuple(t.shape[1:]), dtype=t.dtype,
                              pin_memory=self.pin)
               for n, t in self._flat.items()}
        if self.pin:
            with self._pinned_lock:
                self.pinned_bytes += sum(t.numel() * t.element_size()
                                         for t in out.values())
        return _Stage(out)

    def _thread_ring(self, min_cap: int):
        tls = self._tls
        if getattr(tls, "stages", None) is None or tls.cap < min_cap:
            for st in getattr(tls, "stages", None) or ():
                if st.event is not None:     # copies out of the old ring
                    st.event.synchronize()
            tls.cap = max(self._stage_batch, min_cap)
            tls.stages = [self._alloc_stage(tls.cap)
                          for _ in range(_NUM_STAGING)]
            tls.i = 0
        return tls

    def buffer_shapes(self) -> Dict[str, tuple]:
        return {n: tuple(t.shape[1:]) for n, t in self._flat.items()}

    def fetch(self, keys: Sequence[ExpertKey]) -> StagedBatch:
        """Batched host read: name -> [len(keys), ...] staged contiguously
        (pinned on the card).  The batch stays valid until this thread's
        next-but-one ``fetch``, which first waits for the copies out of it."""
        if self.chaos is not None:
            self.chaos.on_fetch(len(keys))     # may spike (sleep) or raise
        n_keys = len(keys)
        tls = self._thread_ring(n_keys)
        stage = tls.stages[tls.i]
        tls.i = (tls.i + 1) % _NUM_STAGING
        if stage.event is not None:            # its last H2D copies
            stage.event.synchronize()
            stage.event = None
        idx = torch.tensor([l * self.num_experts + e for (l, e) in keys],
                           dtype=torch.int64)
        for n in self.names:
            torch.index_select(self._flat[n], 0, idx,
                               out=stage.tensors[n][:n_keys])
        out = StagedBatch(stage, n_keys)
        if self.chaos is not None:
            self.chaos.maybe_corrupt(
                {n: _bytes(t) for n, t in out.items()})  # STAGED copy only
        return out

    # ------------------------------------------------------------- integrity
    def expected_checksum(self, key: ExpertKey) -> int:
        """Canonical CRC32 of one expert's weight tensors (memoised)."""
        with self._sums_lock:
            s = self._sums.get(key)
        if s is None:
            i = key[0] * self.num_experts + key[1]
            s = 0
            for n in self.names:
                s = zlib.crc32(_bytes(self._flat[n][i]), s)
            with self._sums_lock:
                self._sums[key] = s
        return s

    def payload_checksum(self, arrays: Dict[str, torch.Tensor], i: int
                         ) -> int:
        """CRC32 of row ``i`` of a fetched batch, in canonical name order."""
        s = 0
        for n in self.names:
            s = zlib.crc32(_bytes(arrays[n][i]), s)
        return s

    def verify_payload(self, keys: Sequence[ExpertKey],
                       arrays: Dict[str, torch.Tensor]) -> List[int]:
        """Indices of fetched rows whose staged bytes do not match the
        canonical checksum (empty = clean batch)."""
        return [i for i, k in enumerate(keys)
                if self.payload_checksum(arrays, i) !=
                self.expected_checksum(k)]

    def fetch_verified(self, keys: Sequence[ExpertKey]) -> StagedBatch:
        """``fetch`` + checksum verification: a corrupted staged payload is
        quarantined by raising :class:`PayloadCorruption`."""
        arrays = self.fetch(keys)
        bad = self.verify_payload(keys, arrays)
        if bad:
            self.checksum_failures += len(bad)
            raise PayloadCorruption(
                f"checksum mismatch on fetched experts "
                f"{[tuple(keys[i]) for i in bad]}")
        return arrays

    def expert(self, name: str, layer: int, expert: int) -> torch.Tensor:
        """The canonical host copy of one expert tensor."""
        return self._flat[name][layer * self.num_experts + expert]
