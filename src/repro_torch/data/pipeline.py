"""Deterministic synthetic LM data pipeline with per-host sharding and
background prefetch.  The port of ``repro/data/pipeline.py`` (numpy only).

Tokens follow a Zipf distribution with injected n-gram structure (so
training loss actually decreases and MoE gating sees realistic skew).  Every
batch is a pure function of (seed, host, step): restarts reproduce the exact
stream, and the tokens and labels are the reference's bit for bit.

Added here: a vlm's batch (``num_patches > 0``) also carries
``patch_embeds [B, P, patch_dim]`` f32, standard normal, drawn after the
tokens from the same generator (the stub frontend's precomputed patch
embeddings; the reference's pipeline gives none), and ``make_pipeline``
shortens its text to ``seq_len - num_patches`` so that the cell's
``seq_len`` is the end-to-end length, as the reference's ``input_specs``
does.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np


@dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    num_hosts: int = 1
    host_id: int = 0
    seed: int = 0
    zipf_a: float = 1.3
    ngram_rep: float = 0.3     # probability of copying a recent token (structure)
    num_patches: int = 0       # vlm: patch embeddings per row
    patch_dim: int = 0         # vlm: their width (d_model)


class SyntheticLM:
    def __init__(self, cfg: DataConfig):
        if cfg.global_batch % cfg.num_hosts:
            raise ValueError(f"global batch {cfg.global_batch} does not "
                             f"split over {cfg.num_hosts} hosts")
        self.cfg = cfg
        self.local_batch = cfg.global_batch // cfg.num_hosts
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        p = ranks ** (-cfg.zipf_a)
        self.p = p / p.sum()

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """Batch for (host, step) — deterministic, restart-stable."""
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * 65_537 + cfg.host_id)
        B, S = self.local_batch, cfg.seq_len
        toks = rng.choice(cfg.vocab_size, size=(B, S + 1), p=self.p)
        # n-gram structure: with prob ngram_rep, copy the token 4 back
        rep = rng.random((B, S + 1)) < cfg.ngram_rep
        for off in (4,):
            toks[:, off:] = np.where(rep[:, off:], toks[:, :-off], toks[:, off:])
        out = {"tokens": toks[:, :-1].astype(np.int32),
               "labels": toks[:, 1:].astype(np.int32)}
        if cfg.num_patches:
            out["patch_embeds"] = rng.standard_normal(
                (B, cfg.num_patches, cfg.patch_dim), dtype=np.float32)
        return out


class PrefetchIterator:
    """Background-thread prefetch of upcoming batches (depth-bounded)."""

    def __init__(self, ds: SyntheticLM, start_step: int = 0, depth: int = 2):
        self.ds = ds
        self.step = start_step
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _fill(self):
        s = self.step
        while not self._stop.is_set():
            try:
                self.q.put((s, self.ds.batch_at(s)), timeout=0.2)
                s += 1
            except queue.Full:
                continue

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        s, b = self.q.get()
        self.step = s + 1
        return b

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2)


def make_pipeline(cfg, shape, *, num_hosts: int = 1, host_id: int = 0,
                  seed: int = 0, start_step: int = 0) -> PrefetchIterator:
    """The pipeline of a model config and a shape cell (anything with
    ``vocab_size`` / ``seq_len`` and ``global_batch``), from ``start_step``
    on."""
    patches = getattr(cfg, "num_patches", 0) \
        if getattr(cfg, "family", None) == "vlm" else 0
    dc = DataConfig(vocab_size=cfg.vocab_size,
                    seq_len=max(1, shape.seq_len - patches),
                    global_batch=shape.global_batch, num_hosts=num_hosts,
                    host_id=host_id, seed=seed, num_patches=patches,
                    patch_dim=cfg.d_model if patches else 0)
    return PrefetchIterator(SyntheticLM(dc), start_step)
