"""Request-level serving facade (the public SP-MoE API).  The port of
``repro/core/engine.py``: ``submit``, ``stream``, ``serve`` / ``serve_all``
(several concurrent sessions, one fused verify round per scheduling round)
and ``metrics``.

Two-axis policy model
---------------------
* ``DecodePolicy`` — how tokens are proposed and committed: ``greedy``,
  ``sd`` (fixed-length speculative decoding), ``sd-adaptive``
  (acceptance-EWMA-controlled draft length).
* ``OffloadPolicy`` — where expert weights live and how they move: ``none``
  (all weights resident), ``spmoe`` (drafting-stage cross-model prefetch,
  paper Algorithm 1/2), ``adapmoe`` / ``moe-infinity`` / ``on-demand`` (the
  paper's baselines).

Every combination emits the token stream of target-only greedy decoding.
``greedy × spmoe`` degenerates to on-demand loading: SP-MoE's prefetch
signal is the drafting stage.

A long-lived :class:`Engine` serves a stream of :class:`Request` objects
against one warm expert cache and prefetcher; each finished request returns
a :class:`GenerationResult` with a per-request :class:`Metrics` snapshot.
The engine runs on the card unless it is given ``device="cpu"``.

Decode steps run as captured steps (``core/graphs.py``; CUDA graphs on the
card) over per-session state from a pool that outlives requests: the
offload runtime's verify blocks and draft steps, and for offload none of
an attention-family target the greedy step and the SD iteration.  The SSD
families (ssm, hybrid) decode eagerly.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from enum import Enum
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import sd as S
from repro_torch.core.chaos import ChaosConfig, ExpertLoadError
from repro_torch.core.cutoff import HardwareProfile
from repro_torch.core.graphs import GraphSet, SessionPool
from repro_torch.device import DeviceLike, resolve_device


class DecodePolicy(str, Enum):
    """How tokens are proposed/committed (axis 1 of the policy model)."""
    GREEDY = "greedy"
    SD = "sd"
    SD_ADAPTIVE = "sd-adaptive"


class OffloadPolicy(str, Enum):
    """Where expert weights live / how they move (axis 2)."""
    NONE = "none"
    SPMOE = "spmoe"
    ADAPMOE = "adapmoe"
    MOE_INFINITY = "moe-infinity"
    ON_DEMAND = "on-demand"


DECODE_POLICIES: Tuple[str, ...] = tuple(p.value for p in DecodePolicy)
OFFLOAD_POLICIES: Tuple[str, ...] = tuple(p.value for p in OffloadPolicy)


def derive_draft_config(cfg: ModelConfig) -> ModelConfig:
    """Default draft for a target: its dense sibling (MoE targets) or a
    half-depth copy (dense targets)."""
    if cfg.is_moe:
        return dataclasses.replace(
            cfg, num_experts=0, num_experts_per_tok=0, num_shared_experts=0,
            first_dense_layers=0, name=cfg.name + "-draft")
    return dataclasses.replace(cfg, num_layers=max(2, cfg.num_layers // 2),
                               name=cfg.name + "-draft")


@dataclass
class EngineConfig:
    """Everything an :class:`Engine` needs, in one typed object.
    ``draft`` defaults to :func:`derive_draft_config` of ``model``."""
    model: ModelConfig
    draft: Optional[ModelConfig] = None
    decode: str = DecodePolicy.SD.value
    offload: str = OffloadPolicy.NONE.value
    # speculative decoding
    draft_len: int = 4                  # fixed N for decode == "sd"
    min_draft_len: int = 1              # adaptive controller bounds
    max_draft_len: int = 8
    draft_ewma: float = 0.5             # acceptance EWMA smoothing
    # offload plane
    cache_slots: int = 8
    cutoff: Optional[int] = None        # None -> solver/profile/all layers
    k_prefetch: Optional[int] = None    # None -> num_experts_per_tok
    prefetch_mode: str = "worker"
    batched_io: bool = True
    profile: Optional[HardwareProfile] = None
    # session
    max_seq: int = 512
    # build the offload runtime's fast verify step of every ladder length
    # at init (core/graphs.py: CUDA graphs on the card, static-buffer
    # bodies on the CPU); without it each is built on its first use
    precompile: bool = True
    # resilience plane (see core/chaos.py + the Prefetcher docstring)
    chaos: Optional[ChaosConfig] = None
    prefetch_retries: int = 3           # per-task transient-I/O retry budget
    retry_backoff_s: float = 0.002      # exponential backoff base
    task_timeout_s: Optional[float] = None   # per prefetch-task deadline
    drain_timeout_s: float = 30.0       # bound on per-session I/O waits
    verify_payloads: Optional[bool] = None   # None -> on iff chaos enabled
    max_worker_restarts: int = 3        # supervised-worker restart budget
    fail_threshold: int = 3             # consecutive failures -> degraded
    heartbeat_timeout_s: float = 10.0   # wedged-worker detection
    io_retries: int = 3                 # on-demand (decode-critical) retries

    def __post_init__(self):
        self.decode = DecodePolicy(self.decode).value
        self.offload = OffloadPolicy(self.offload).value
        if self.offload != OffloadPolicy.NONE.value and not self.model.is_moe:
            raise ValueError(
                f"offload policy {self.offload!r} requires an MoE target "
                f"(model {self.model.name!r} is dense)")
        if self.model.family in ("ssm", "hybrid") \
                and self.decode != DecodePolicy.GREEDY.value:
            raise ValueError(
                f"decode {self.decode!r} verifies blocks of several tokens "
                f"in one target step, and the {self.model.family} target "
                f"{self.model.name!r} cannot: its mamba layers' recurrent "
                f"decode takes one token per step (the reference reads only "
                f"a block's first token and spreads its output over the "
                f"block); use decode='greedy'")
        if self.decode == DecodePolicy.SD.value and self.draft_len < 1:
            raise ValueError("decode='sd' needs draft_len >= 1")
        if not 1 <= self.min_draft_len <= self.max_draft_len:
            raise ValueError("need 1 <= min_draft_len <= max_draft_len")

    @property
    def needs_draft(self) -> bool:
        return self.decode != DecodePolicy.GREEDY.value

    @property
    def resolved_verify_payloads(self) -> bool:
        """Checksum verification: explicit setting wins; otherwise on
        exactly when fault injection is configured."""
        if self.verify_payloads is not None:
            return self.verify_payloads
        return self.chaos is not None and self.chaos.enabled

    def resolved_draft(self) -> ModelConfig:
        return self.draft if self.draft is not None \
            else derive_draft_config(self.model)

    @property
    def initial_draft_len(self) -> int:
        """Draft tokens per iteration at session start (0 = no drafting)."""
        if self.decode == DecodePolicy.GREEDY.value:
            return 0
        if self.decode == DecodePolicy.SD_ADAPTIVE.value:
            return self.min_draft_len
        return self.draft_len


@dataclass
class Request:
    """One generation request.  ``prompt`` is a ``[1, P]`` int tensor or
    array (or a plain list of token ids).  Generation ends after
    ``max_new_tokens`` tokens or right after the first emitted token in
    ``stop_tokens``; ``deadline_s`` is a wall-clock budget from the first
    decode turn (``finish_reason="deadline"``)."""
    prompt: Any
    max_new_tokens: int = 32
    stop_tokens: Sequence[int] = ()
    request_id: Optional[str] = None
    deadline_s: Optional[float] = None

    def prompt_tensor(self, device: torch.device) -> torch.Tensor:
        p = torch.as_tensor(self.prompt).to(torch.int64)
        if p.dim() == 1:
            p = p[None, :]
        if p.dim() != 2 or p.shape[0] != 1:
            raise ValueError("requests are batch-1 [1, P]")
        return p.to(device)


# the counters OffloadEngine.counters() exposes — the one list the runtime
# snapshot and the per-request delta iterate (each name is a Metrics field)
RUNTIME_COUNTER_KEYS = ("lookups", "hits", "on_demand_loads", "prefetched",
                        "evictions", "prefetch_evicted_unused", "host_syncs",
                        "verify_blocks", "fast_blocks", "fast_fallbacks",
                        "iterations", "drafted", "accepted",
                        # resilience plane (prefetcher/store health)
                        "prefetch_errors", "prefetch_retries",
                        "checksum_failures", "worker_restarts",
                        "degraded_rounds", "io_errors")

# counter fields that accumulate when combining Metrics
_COUNTERS = ("requests", "tokens") + RUNTIME_COUNTER_KEYS


@dataclass
class Metrics:
    """One typed stats object for every serving path: raw counters, with
    the ratios as derived properties."""
    requests: int = 0
    tokens: int = 0
    wall_s: float = 0.0
    iterations: int = 0
    drafted: int = 0
    accepted: int = 0
    # offload plane (zero when offload == "none")
    lookups: int = 0
    hits: int = 0
    on_demand_loads: int = 0
    prefetched: int = 0
    evictions: int = 0
    prefetch_evicted_unused: int = 0
    host_syncs: int = 0
    verify_blocks: int = 0
    fast_blocks: int = 0
    fast_fallbacks: int = 0
    # resilience plane (zero on a healthy run)
    prefetch_errors: int = 0
    prefetch_retries: int = 0
    checksum_failures: int = 0
    worker_restarts: int = 0
    degraded_rounds: int = 0
    io_errors: int = 0
    cutoff_layer: int = -1              # configuration echo, not a counter

    @property
    def tpot_wall(self) -> float:
        return self.wall_s / max(self.tokens, 1)

    @property
    def acceptance_rate(self) -> float:
        return self.accepted / max(self.drafted, 1)

    @property
    def hit_rate(self) -> float:
        return self.hits / max(self.lookups, 1)

    @property
    def tokens_per_iteration(self) -> float:
        return self.tokens / max(self.iterations, 1)

    def add(self, other: "Metrics") -> "Metrics":
        """Accumulate ``other`` into self (cumulative view)."""
        for f in _COUNTERS:
            setattr(self, f, getattr(self, f) + getattr(other, f))
        self.wall_s += other.wall_s
        if other.cutoff_layer >= 0:
            self.cutoff_layer = other.cutoff_layer
        return self

    def as_dict(self) -> Dict[str, float]:
        d = {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}
        d.update(tpot_wall=self.tpot_wall, acceptance_rate=self.acceptance_rate,
                 hit_rate=self.hit_rate,
                 tokens_per_iteration=self.tokens_per_iteration)
        return d

    def __getitem__(self, key: str):
        return self.as_dict()[key]


@dataclass
class GenerationResult:
    """Outcome of one request: the committed tokens, why generation stopped
    (``"length"``, ``"stop"``, ``"aborted"``, ``"deadline"``,
    ``"cancelled"`` or ``"io_error"``), and that request's Metrics."""
    tokens: List[int]
    finish_reason: str
    metrics: Metrics
    request_id: Optional[str] = None

    def token_tensor(self) -> torch.Tensor:
        return torch.tensor(self.tokens, dtype=torch.int64)


class Session:
    """One in-flight request on an :class:`Engine`: the decode state
    (started lazily on the first turn), the emitted tokens, the finish
    reason, the wall clock and a per-turn counter-delta ledger."""

    def __init__(self, engine: "Engine", request: Request):
        if engine._closed:
            raise RuntimeError("engine is closed")
        self.engine = engine
        self.request = request
        self._prompt = request.prompt_tensor(engine.device)
        need = self._prompt.shape[1] + request.max_new_tokens + \
            engine._max_block_len() + 1
        if need > engine.config.max_seq:
            raise ValueError(
                f"request needs {need} positions but max_seq is "
                f"{engine.config.max_seq}; raise EngineConfig.max_seq")
        self._stop = set(int(t) for t in request.stop_tokens)
        self.sstats: Dict[str, Any] = {"iterations": 0, "drafted": 0,
                                       "accepted": 0}
        self.dstate = None              # runtime DecodeState, lazily started
        self.gen = None if engine.runtime is not None else \
            engine._chunk_stream(self._prompt, request.max_new_tokens,
                                 self.sstats)
        self.ledger: Dict[str, int] = {k: 0 for k in RUNTIME_COUNTER_KEYS}
        self.emitted: List[int] = []
        self.wall = 0.0                 # decode-side time, not consumer time
        self.result: Optional[GenerationResult] = None
        self._deadline: Optional[float] = None

    @property
    def done(self) -> bool:
        return self.result is not None

    def expired(self) -> bool:
        return self._deadline is not None and time.monotonic() > self._deadline

    def _arm_deadline(self):
        if self._deadline is None and self.request.deadline_s is not None:
            self._deadline = time.monotonic() + self.request.deadline_s

    def cancel(self, reason: str = "cancelled"):
        """Retire an unfinished session early (idempotent)."""
        if not self.done:
            self._finalize(reason)

    def _step(self, fn):
        """Run one decode-side step under this session's wall clock and
        counter ledger."""
        before = self.engine._counters()
        t0 = time.perf_counter()
        try:
            return fn()
        finally:
            self.wall += time.perf_counter() - t0
            after = self.engine._counters()
            for k in self.ledger:
                self.ledger[k] += after.get(k, 0) - before.get(k, 0)

    def _advance(self) -> Optional[List[int]]:
        rt = self.engine.runtime
        if rt is not None:
            if self.dstate is None:
                self.dstate = rt.start_session(self._prompt,
                                               self.request.max_new_tokens)
            return rt.session_turn(self.dstate)
        try:
            return next(self.gen)
        except StopIteration:
            return None

    def _close_decode(self):
        if self.engine.runtime is not None:
            if self.dstate is not None:
                self.engine.runtime.finish_session(self.dstate)
        else:
            self.gen.close()

    def turn(self) -> Optional[List[int]]:
        """Advance one committed verify block; returns the newly committed
        tokens (truncated right after a stop token) or None when done."""
        if self.done:
            return None
        if self.expired():
            self._finalize("deadline")
            return None
        self._arm_deadline()
        try:
            chunk = self._step(self._advance)
        except ExpertLoadError:
            self._finalize("io_error")
            return None
        return self._commit_chunk(chunk)

    def deliver(self, chunk, delta: Dict[str, int],
                wall: float) -> Optional[List[int]]:
        """Commit a chunk produced by a batched round
        (``OffloadEngine.session_turns``): fold the round's counter delta
        for this session and its decode wall time into the ledger, then run
        the same stop-token / finish logic as :meth:`turn`.  A chunk that is
        an :class:`ExpertLoadError` retires the session with
        ``finish_reason="io_error"``; its batchmates are untouched."""
        if self.done:
            return None
        for k in self.ledger:
            self.ledger[k] += delta.get(k, 0)
        self.wall += wall
        if isinstance(chunk, ExpertLoadError):
            self._finalize("io_error")
            return None
        return self._commit_chunk(chunk)

    def _commit_chunk(self, chunk: Optional[List[int]]
                      ) -> Optional[List[int]]:
        if chunk is None:
            self._finalize("length")
            return None
        out: List[int] = []
        for tok in chunk:
            tok = int(tok)
            self.emitted.append(tok)
            out.append(tok)
            if tok in self._stop:
                self._finalize("stop")
                break
        return out

    def abort(self):
        """Retire an unfinished session as ``"aborted"`` (no-op when
        already finished); the engine stays warm and reusable."""
        if not self.done:
            self._finalize("aborted")

    def _finalize(self, finish: str):
        self._step(self._close_decode)
        m = Metrics(requests=1, tokens=len(self.emitted), wall_s=self.wall,
                    cutoff_layer=self.engine.cutoff_layer)
        if self.engine.runtime is not None:
            for k, v in self.ledger.items():
                setattr(m, k, v)
            if self.dstate is not None:
                # owner-attributed I/O counters (see DecodeState.io)
                for k, v in self.dstate.io.items():
                    setattr(m, k, v)
        else:
            m.iterations = self.sstats["iterations"]
            m.drafted = self.sstats["drafted"]
            m.accepted = self.sstats["accepted"]
        self.result = GenerationResult(tokens=list(self.emitted),
                                       finish_reason=finish, metrics=m,
                                       request_id=self.request.request_id)
        self.engine._cum.add(m)
        self.engine.last_result = self.result


class Engine:
    """Long-lived serving engine: one warm expert cache and prefetcher, many
    requests.

    ``target`` / ``draft`` are the port's models (``models/transformer.py``);
    when omitted they are built from ``seed`` / ``draft_seed`` on
    ``device`` (default: the card).  With an offload policy, a target built
    here keeps its routed experts in host memory only; a target handed in
    keeps them as they are (so a caller may hand the target in as its own
    draft), and the runtime never reads them.  A draft keeps its experts on
    the device.  ``close()`` (or use as a context manager) stops the
    prefetch worker."""

    def __init__(self, config: EngineConfig, target=None, draft=None, *,
                 seed: int = 0, draft_seed: int = 1,
                 device: DeviceLike = None):
        from repro_torch.models.registry import build_model
        self.config = config
        offload = config.offload != OffloadPolicy.NONE.value
        self.device = target.device if target is not None \
            else resolve_device(device)
        own_target = target is None
        self.target = target if target is not None else build_model(
            config.model, self.device, seed=seed,
            expert_device="cpu" if offload else None)
        self.draft_cfg = config.resolved_draft() if config.needs_draft \
            else None
        self.draft = draft
        if self.draft is None and self.draft_cfg is not None:
            self.draft = build_model(self.draft_cfg, self.device,
                                     seed=draft_seed)
        self.runtime = None             # OffloadEngine when offload != none
        # offload none: captured steps and their pool (attention families)
        self.graphs: Optional[GraphSet] = None
        self._pool: Optional[SessionPool] = None
        if offload:
            from repro_torch.core.runtime import OffloadEngine
            self.runtime = OffloadEngine(config, self.target, self.draft)
            if own_target:              # the store now holds the experts
                self.target.drop_experts()
            self.graphs = self.runtime.graphs
        elif config.model.family in ("dense", "moe"):
            self.graphs = GraphSet(self.device)
            self._pool = SessionPool(self.target, self.draft,
                                     config.max_seq)
        self._cum = Metrics(cutoff_layer=self.cutoff_layer)
        self.last_result: Optional[GenerationResult] = None
        self.last_batch: List[GenerationResult] = []
        self._closed = False

    @property
    def cutoff_layer(self) -> int:
        return self.runtime.cutoff if self.runtime is not None else -1

    def submit(self, request: Request) -> GenerationResult:
        """One-shot: run the request to completion, return the result."""
        session = Session(self, request)
        while session.turn() is not None:
            pass
        return session.result

    def stream(self, request: Request) -> Iterator[int]:
        """Yield token ids as each verify block commits.  After exhaustion
        the request's result is at ``self.last_result``; an abandoned stream
        retires the request with ``finish_reason="aborted"``."""
        session = Session(self, request)
        try:
            while True:
                chunk = session.turn()
                if chunk is None:
                    break
                for tok in chunk:
                    yield tok
                if session.done:       # stop token committed mid-chunk
                    break
        finally:
            session.abort()            # no-op unless abandoned mid-stream

    def serve(self, requests: Sequence[Request], *, concurrency: int = 2
              ) -> Iterator[Tuple[str, int]]:
        """Round-robin scheduler: up to ``concurrency`` sessions at a time
        each commit one verify block per round on the one warm expert cache;
        further requests are admitted as sessions finish.  With an offload
        runtime, the started sessions of a round verify together
        (``OffloadEngine.session_turns``: one fused ``cache_moe`` launch per
        MoE layer, ≤2 host syncs per round); a fresh admission prefills and
        delivers its first token solo, and engines without an offload
        runtime turn every session solo.

        Yields ``(request_id, token)`` pairs in commit order (request_id
        defaults to ``"req-<index>"``).  ``self.last_batch`` is reset to
        ``[]`` here and holds the results in request order once the iterator
        ends, also when it is closed early (which aborts the unfinished
        sessions)."""
        if concurrency < 1:
            raise ValueError("concurrency must be >= 1")
        sessions = [Session(self, r) for r in requests]
        names = [s.request.request_id or f"req-{i}"
                 for i, s in enumerate(sessions)]
        self.last_batch = []
        return self._serve_iter(names, sessions, concurrency)

    def _serve_iter(self, names: List[str], sessions: List[Session],
                    concurrency: int) -> Iterator[Tuple[str, int]]:
        try:
            waiting = list(zip(names, sessions))
            active: List[Tuple[str, Session]] = []
            while active or waiting:
                while waiting and len(active) < concurrency:
                    active.append(waiting.pop(0))
                # an expired session is retired here, as a finished one
                # falls out of the round
                for _, s in active:
                    if not s.done and s.expired():
                        s.cancel("deadline")
                round_ss = [s for _, s in active
                            if not s.done and s.dstate is not None]
                delivered: Dict[int, Optional[List[int]]] = {}
                if round_ss:
                    res = self.runtime.session_turns(
                        [s.dstate for s in round_ss])
                    for s, (chunk, delta, wall) in zip(round_ss, res):
                        delivered[id(s)] = s.deliver(chunk, delta, wall)
                for name, s in list(active):
                    chunk = delivered[id(s)] if id(s) in delivered \
                        else s.turn()
                    if s.done:
                        active.remove((name, s))
                    for tok in chunk or ():
                        yield name, tok
        finally:
            for s in sessions:
                s.abort()              # no-op on finished sessions
            self.last_batch = [s.result for s in sessions]

    def serve_all(self, requests: Sequence[Request], *, concurrency: int = 2
                  ) -> List[GenerationResult]:
        """Drain :meth:`serve`; returns the results in request order."""
        for _ in self.serve(requests, concurrency=concurrency):
            pass
        return self.last_batch

    def metrics(self) -> Metrics:
        """Cumulative Metrics across every request this engine served."""
        return dataclasses.replace(self._cum)

    def reset_stats(self):
        """Zero the cumulative counters (engine + cache + prefetcher) so a
        warmed engine reports clean steady-state numbers."""
        self._cum = Metrics(cutoff_layer=self.cutoff_layer)
        if self.runtime is not None:
            self.runtime.reset_stats()

    def close(self):
        if not self._closed and self.runtime is not None:
            self.runtime.close()
        self._closed = True

    def __enter__(self) -> "Engine":
        return self

    def __exit__(self, *exc):
        self.close()

    def _max_block_len(self) -> int:
        cfg = self.config
        if cfg.decode == DecodePolicy.SD_ADAPTIVE.value:
            return cfg.max_draft_len + 1
        return cfg.initial_draft_len + 1

    def _chunk_stream(self, prompt, max_new_tokens, sstats):
        """The committed-chunk generator for engines without an offload
        runtime (offload == none); it holds a pool slot while it runs."""
        cfg = self.config
        kw = dict(stats=sstats, graphs=self.graphs, pool=self._pool)
        if cfg.decode == DecodePolicy.GREEDY.value:
            return S.greedy_stream(self.target, prompt, max_new_tokens,
                                   cfg.max_seq, **kw)
        if cfg.decode == DecodePolicy.SD.value:
            return S.sd_stream(self.draft, self.target, prompt,
                               max_new_tokens, cfg.draft_len, cfg.max_seq,
                               **kw)
        return S.sd_adaptive_stream(self.draft, self.target, prompt,
                                    max_new_tokens, cfg.max_seq,
                                    min_len=cfg.min_draft_len,
                                    max_len=cfg.max_draft_len,
                                    ewma=cfg.draft_ewma, **kw)

    def _counters(self) -> Dict[str, int]:
        return self.runtime.counters() if self.runtime is not None else {}
