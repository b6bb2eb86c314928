"""SP-MoE offload-mode serving engine.  The port of ``repro/core/runtime.py``:
the batched cross-session round (``session_turns``), of which the solo turn
(``session_turn``) is a round of one.

It combines every paper component end to end:

  * speculative decoding (batch 1, greedy accept) — core/sd.py semantics;
  * target expert weights offloaded to a HostExpertStore; a fixed-slot
    ExpertCache with LRU lives on the device;
  * drafting-stage cross-model prediction: draft gate-input taps × target
    gating networks -> prefetch tasks for layers 0..cutoff (Algorithm 1);
  * pipelined prefetching: supervised worker + batched I/O (Algorithm 2);
  * cached-first expert computation (§4.3): the hit experts' FFN is
    dispatched while the misses stream in.

Verification paths (both run the slot-indexed kernel ``ops.cache_moe``):

* **fast path** — every layer is dispatched without a host round trip:
  routing, slot translation (a gather from ``table_dev [L, E]``), the hit
  mask, the cached-expert FFN and the history accounting stay on the
  device, which also reduces an ``all_hit`` flag.  Reading that one flag is
  the block's only sync; with the accept/reject readback that is ≤2 host
  syncs per verify block.  If an expert was missing the block's logits are
  discarded and the slow path re-runs it: the KV caches are written in
  place, but the re-run writes the same slots for the same positions before
  any query reads them.
* **fused round** — the fast path for several sessions at once: one
  ``cache_moe`` launch per MoE layer over every session's rows, ≤2 host
  syncs per round (``_verify_fast_batched``); a session that missed re-runs
  alone on the slow path.
* **slow path (miss resolution)** — layer by layer: routing ids are read
  back once per layer, missing experts are loaded in cache-capacity-bounded
  waves while the cached-first compute runs, and each wave's share is added
  by the same kernel with that wave's slots unmasked.  A block with zero
  misses re-arms the fast path.

Both paths run the target's leading dense layers first (``dense_stack``) and
add each MoE layer's shared experts to its routed sum, per session at the
solo block's shapes.  Routed expert weights are never read
from the target model on the hot path: both paths read them only from the
ExpertCache slot pool.  A draft that is itself an MoE (phi-mini-moe,
deepseek's self-draft) keeps its own experts resident on the device and
runs them through ``moe_global``'s expert-FFN kernel, with no host sync, so
its drafting step reads back one token, as a dense draft's does.

Captured steps (``core/graphs.py``, the port of the reference's jitted
``_verify_fast`` / ``_verify_fast_batched`` / ``_draft_step``).  Every
session holds a slot of a ``SessionPool`` (its KV caches, draft cache and
history) from ``start_session`` to ``finish_session``.  The fast verify
block of a ladder length (``_ladder``) runs as a captured step keyed by
(slot, T), a fused round by the tuple of its sessions' (slot, T) in slot
order, a draft step by (slot, route); the fused keys are built on first
use and never freed, so their number grows with the distinct rounds served
(at most one per subset of slots and choice of ladder lengths);
``EngineConfig.precompile`` builds slot 0's whole
ladder at init, as ``_precompile_fast`` pre-traces it.  A fast block of
another length (an all-hit prefill) runs the eager body and is counted in
``eager_fast_blocks``.  The replays keep the pool's reader wait and its
release event outside the capture (``ExpertCache.reading``).

Host-sync accounting: every blocking device->host readback on the decode
path goes through ``_readback`` (tests spy on it) and is counted in
``host_syncs``.  The drafting stage's token and prediction readbacks, and
the per-session metrics readback at retirement, are not counted, as in the
reference.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import sd as S
from repro_torch.core.cache import ExpertCache, ExpertKey, host_to_device
from repro_torch.core.chaos import ChaosInjector, ExpertLoadError
from repro_torch.core.cutoff import solve_cutoff
from repro_torch.core.engine import (RUNTIME_COUNTER_KEYS, DecodePolicy,
                                     EngineConfig)
from repro_torch.core.graphs import GraphSet, SessionPool, SessionSlot
from repro_torch.core.offload import HostExpertStore
from repro_torch.core.predictor import ExpertPredictor
from repro_torch.core.prefetcher import Prefetcher
from repro_torch.kernels import ops
from repro_torch.models.layers import ffn_forward
from repro_torch.models.moe import gate_topk
from repro_torch.models.transformer import reset_cache

POLICIES = ("spmoe", "adapmoe", "moe-infinity", "on-demand")


def _cat(ts: List[torch.Tensor]) -> torch.Tensor:
    """``torch.cat`` along dim 0 that copies nothing for a single tensor."""
    return ts[0] if len(ts) == 1 else torch.cat(ts)


@dataclasses.dataclass
class DecodeState:
    """Everything one in-flight request mutates while decoding: KV and
    draft caches, position, the draft-length controller, request-level
    MoE-Infinity history, fast-path arming and the device-side fast-hit
    accumulator.  The caches and the history are those of ``slot``, the
    session's pool slot while it runs.  The engine keeps the shared
    runtime (cache, prefetcher) and cumulative counters."""
    max_new: int
    tcache: Any
    slot: Optional[SessionSlot] = None
    dcache: Any = None
    cur: Optional[torch.Tensor] = None
    pos: int = 0
    n: int = 0                        # current draft length (0 = greedy)
    acc_ewma: float = 0.5
    emitted_total: int = 0
    pending: Optional[List[int]] = None   # prefill chunk awaiting delivery
    history_dev: Any = None           # MoE-Infinity request-level history
    fast_ok: bool = False
    fast_penalty: int = 0
    fast_active_dev: Any = None       # device-side fast-path hit accumulator
    fast_blocks: int = 0
    inflight: List[Any] = dataclasses.field(default_factory=list)
    finished: bool = False
    committed: bool = False
    # owner-attributed I/O ledger: this session's synchronous inserts and
    # (folded in at retirement) its prefetch tasks' stats
    io: Dict[str, int] = dataclasses.field(default_factory=lambda: {
        "prefetched": 0, "evictions": 0, "prefetch_evicted_unused": 0})


class OffloadEngine:
    def __init__(self, config: EngineConfig, target, draft=None):
        """``target`` / ``draft`` are the port's models; their device is
        the engine's.  The target's routed experts are copied to the host
        store here and never read from the model again."""
        cfg = config.model
        if config.offload not in POLICIES:
            raise ValueError(f"unknown offload policy {config.offload!r}")
        if not cfg.is_moe:
            raise ValueError("offload engine targets MoE models")
        if config.needs_draft and draft is None:
            raise ValueError(f"decode={config.decode!r} needs a draft model")
        self.config = config
        self.cfg = cfg
        self.policy = config.offload
        self.decode = config.decode
        self.draft_len = config.initial_draft_len
        self.max_seq = config.max_seq
        self.target = target
        self.device = target.device
        self.draft = draft if config.needs_draft else None
        self.chaos = ChaosInjector(config.chaos) \
            if config.chaos is not None and config.chaos.enabled else None
        self.store = HostExpertStore(cfg, target, chaos=self.chaos,
                                     pin=self.device.type == "cuda")
        self.cache = ExpertCache(
            config.cache_slots, self.store.buffer_shapes(), target.dtype,
            table_shape=(self.store.num_layers, cfg.num_experts),
            chaos=self.chaos, device=self.device)
        mode = config.prefetch_mode if self.policy in ("spmoe", "moe-infinity") \
            else ("vanilla" if self.policy == "adapmoe" else "off")
        self.prefetcher = Prefetcher(
            self.store, self.cache, mode, config.batched_io,
            retries=config.prefetch_retries,
            backoff_s=config.retry_backoff_s,
            task_timeout_s=config.task_timeout_s,
            verify=config.resolved_verify_payloads,
            heartbeat_timeout_s=config.heartbeat_timeout_s,
            max_worker_restarts=config.max_worker_restarts,
            fail_threshold=config.fail_threshold,
            chaos=self.chaos)
        self.k = config.k_prefetch if config.k_prefetch is not None \
            else cfg.num_experts_per_tok
        self.predictor = ExpertPredictor(cfg, target, self.k)
        if config.cutoff is not None:
            self.cutoff = config.cutoff
        elif config.profile is not None:
            self.cutoff = solve_cutoff(config.profile, self.k,
                                       self.store.num_layers,
                                       max(self.draft_len, 1)).cutoff_layer
        else:
            self.cutoff = self.store.num_layers - 1
        self._hist_shape = (self.store.num_layers, cfg.num_experts)
        # stats (engine-global: cumulative across every session)
        self.layer_hits = 0
        self.layer_lookups = 0
        self.on_demand_loads = 0
        self.host_syncs = 0
        self.verify_blocks = 0
        self.fast_blocks = 0
        self.fast_fallbacks = 0
        self.iterations = 0
        self.drafted = 0
        self.accepted = 0
        # round-level accounting of the batched cross-session scheduler (not
        # part of counters()): verify_rounds counts session_turns rounds that
        # verified at least one block (a solo turn is a round of one),
        # round_launches the verify dispatches those rounds needed — one
        # fused dispatch per all-hit round however many sessions it served
        self.verify_rounds = 0
        self.round_launches = 0
        # graceful-degradation ladder: while the prefetch plane is unhealthy
        # the policy steps down to on-demand loading (see _check_health)
        self._degraded = False
        self.degraded_rounds = 0
        self.io_errors = 0
        # last observed arming of the shared cache: seeds new sessions
        self._fast_hint = False
        self._st: Optional[DecodeState] = None   # state bound to this turn
        # captured steps and the per-session state they read
        self.graphs = GraphSet(self.device)
        self.pool = SessionPool(self.target, self.draft, self.max_seq,
                                self._hist_shape)
        self.eager_fast_blocks = 0       # fast blocks of a length off _ladder
        if config.precompile:
            self._precompile_fast()

    def _ladder(self) -> Tuple[int, ...]:
        """The verify block lengths a decode turn makes: draft_len + 1, the
        adaptive controller's min..max + 1, or 1 for greedy."""
        cfg = self.config
        if self.decode == DecodePolicy.SD_ADAPTIVE.value:
            return tuple(range(cfg.min_draft_len + 1, cfg.max_draft_len + 2))
        return (self.draft_len + 1,)

    def _precompile_fast(self):
        """Build the fast verify step of every ladder length for pool slot
        0 (the reference pre-traces ``_verify_fast`` for one
        session-shaped cache), so that no armed fast block captures while
        it serves.  Nothing inserts yet, so every routed expert misses and
        the warm-up's cache writes are undone by the next prefill."""
        slot = self.pool.take()
        try:
            for T in self._ladder():
                tokens = torch.zeros((1, T), dtype=torch.int64,
                                     device=self.device)
                key, body = self._fast_step([slot], [tokens], [0])
                with self.cache.reading():
                    self.graphs.build(key, body, [tokens, 0])
        finally:
            self.pool.give(slot)

    # ------------------------------------------------------------------ sync
    def _readback(self, x: torch.Tensor) -> np.ndarray:
        """The only counted device->host sync point on the decode path."""
        self.host_syncs += 1
        return x.cpu().numpy()

    # ------------------------------------------------------------- pieces
    def _moe_apply(self, bufs, x: torch.Tensor, slot_ids: torch.Tensor,
                   weights: torch.Tensor) -> torch.Tensor:
        """x: [T,d]; slot_ids/weights: [T,k] -> [T,d] over the slot pool;
        slot_ids < 0 contribute 0."""
        return ops.cache_moe(x, slot_ids, weights, bufs["wu"], bufs["wd"],
                             bufs.get("wg"))

    def _gate(self, l: int, h2: torch.Tensor):
        w, ids, probs, _ = gate_topk(self.target.layers[l].moe.gate,
                                     h2.reshape(-1, self.cfg.d_model),
                                     self.cfg.num_experts_per_tok)
        return w, ids, probs

    def _verify_fast(self, tokens: torch.Tensor, pos: int,
                     slot: SessionSlot):
        """The whole verify block over ``slot``'s cache and history,
        speculating that every routed expert is cache-resident: a round of
        one session (``_verify_fast_batched``).  Returns (logits, all_hit,
        new_history, n_active); nothing here syncs with the host."""
        logits, ok, hists, nact = self._verify_fast_batched(
            [tokens], [pos], [slot])
        return logits[0], ok[0], hists[0], nact[0]

    def _verify_fast_batched(self, tokens: List[torch.Tensor],
                             pos: List[int], slots: List[SessionSlot]):
        """A whole scheduling round on the fast path over the sessions' pool
        slots (their caches and histories), as the captured step of its
        key.  The step takes the sessions in slot order, so the order in
        which a round lists them builds nothing new; the outputs come back
        in the round's order.  A solo block of a length off ``_ladder``
        runs ``_fast_body`` eagerly and is counted in
        ``eager_fast_blocks``.  The outputs of a captured step are valid
        until its key's next run."""
        with self.cache.reading():
            if len(slots) == 1 and tokens[0].shape[1] not in self._ladder():
                self.eager_fast_blocks += 1
                return self._fast_body(tokens, pos, [slots[0].tcache],
                                       [slots[0].history])
            order = sorted(range(len(slots)), key=lambda i: slots[i].index)
            toks = [tokens[i] for i in order]
            ps = [pos[i] for i in order]
            key, body = self._fast_step([slots[i] for i in order], toks, ps)
            logits, ok, hists, nact = self.graphs.run(key, body, *toks, *ps)
            if order == sorted(order):
                return logits, ok, hists, nact
            back = [0] * len(order)             # back[i]: session i's row
            for j, i in enumerate(order):
                back[i] = j
            return ([logits[j] for j in back],
                    torch.stack([ok[j] for j in back]),
                    [hists[j] for j in back],
                    torch.stack([nact[j] for j in back]))

    def _fast_step(self, slots: List[SessionSlot],
                   tokens: List[torch.Tensor], pos: List[int]):
        """(key, body) of the captured fast step over ``slots``: the body
        takes the blocks and their positions (0-d int32 on the device) and
        runs ``_fast_body`` over the slots' caches and histories.  The key
        holds each session's (slot, T, flash-decode route); the route and
        an MLA block's fit are the host's, checked here at every run."""
        routes = tuple(
            (s.index, int(t.shape[1]),
             self.target.decode_route(s.tcache, p, int(t.shape[1]), True)[1])
            for s, t, p in zip(slots, tokens, pos))
        key = ("fused" if len(slots) > 1 else "fast",) + routes
        n = len(slots)
        host_pos = list(pos)
        tcaches = [s.tcache for s in slots]
        hists = [s.history for s in slots]

        def body(*ins):
            return self._fast_body(list(ins[:n]), host_pos, tcaches, hists,
                                   list(ins[n:]))
        return key, body

    def _fast_body(self, tokens: List[torch.Tensor], pos: List[int],
                   tcaches: List[Any], histories: List[torch.Tensor],
                   pos_dev: Optional[List[torch.Tensor]] = None):
        """The fast path's device work for a round: every ready session's
        verify block ``tokens[i]`` ([1, T_i], ragged) at once, speculating
        that every routed expert is cache-resident.  ``pos_dev``: the
        positions as 0-d int32 device tensors (a captured step's); without
        it the host ints are.

        The dense layers, attention, the gate, the shared experts and the
        head run per session, at the shapes of the solo ``_verify_fast`` (a
        product over more rows may sum each row in another order).  What is
        fused is the one batch-invariant step:
        per MoE layer, ONE ``ops.cache_moe`` call over the concatenated
        [ΣT_i, d] rows.  So on one cache snapshot each session's logits are
        bit-identical to its solo fast block.

        Returns (logits per session, ok [N] all-hit flags, new histories,
        nact [N]); nothing here syncs with the host.  A round of one (the
        solo block) issues no concatenating copy.  KV caches are written
        in place: a session that missed re-runs its block, which rewrites
        the same slots before any query reads them."""
        cfg, tgt = self.cfg, self.target
        n = len(tokens)
        Ts = [int(t.shape[1]) for t in tokens]
        offs = np.cumsum([0] + Ts).tolist()
        E = cfg.num_experts
        oks = [torch.ones((), dtype=torch.bool, device=self.device)
               for _ in range(n)]
        nacts = [torch.zeros((), dtype=torch.float32, device=self.device)
                 for _ in range(n)]
        acts: List[List[torch.Tensor]] = [[] for _ in range(n)]
        pds = pos_dev if pos_dev is not None else [None] * n
        bufs, table = self.cache.bufs, self.cache.table_dev
        xs = [tgt.dense_stack(tgt.embed(t), tc, p, pd)
              for t, tc, p, pd in zip(tokens, tcaches, pos, pds)]
        for l in range(self.store.num_layers):
            h2s, slots, ws = [], [], []
            for i in range(n):
                xs[i], h2 = tgt.attn_half(l, xs[i],
                                          tcaches[i]["layers"][l], pos[i],
                                          pds[i])
                w, ids, _ = self._gate(l, h2)
                slot_ids = table[l][ids]           # [T_i, k]; -1 = miss
                hit = slot_ids >= 0
                oks[i] = oks[i] & torch.all(hit)
                h2s.append(h2)
                slots.append(slot_ids)
                ws.append(torch.where(hit, w, torch.zeros_like(w)))
                flat = ids.reshape(-1)
                activated = torch.zeros(E, dtype=torch.int32,
                                        device=self.device).index_add_(
                    0, flat, torch.ones_like(flat, dtype=torch.int32)) > 0
                nacts[i] = nacts[i] + activated.sum().float()
                acts[i].append(activated)
            y = self._moe_apply(
                bufs, _cat([h.reshape(T, cfg.d_model)
                            for h, T in zip(h2s, Ts)]),
                _cat(slots), _cat(ws))                     # ONE launch
            for i in range(n):
                xs[i] = self._add_moe_out(
                    l, xs[i], h2s[i],
                    y[offs[i]:offs[i + 1]].reshape(1, Ts[i], cfg.d_model))
        logits = [tgt.logits(x) for x in xs]
        new_hists = [h + torch.stack(a).to(h.dtype)
                     for h, a in zip(histories, acts)]
        return (logits, _cat([o.reshape(1) for o in oks]), new_hists,
                _cat([a.reshape(1) for a in nacts]))

    def _add_moe_out(self, l: int, x: torch.Tensor, h2: torch.Tensor,
                     y: torch.Tensor) -> torch.Tensor:
        """x + (routed sum y + the shared experts on h2): MoE layer ``l``'s
        residual add, in the reference's order."""
        if self.cfg.num_shared_experts:
            y = y + ffn_forward(self.target.layers[l].moe.shared, h2,
                                "swiglu")
        return x + y

    # ------------------------------------------------------------- verification
    def _ensure_loaded(self, layer: int, ids: np.ndarray
                       ) -> Tuple[Dict[ExpertKey, int], List[ExpertKey]]:
        keys = [(layer, int(e)) for e in dict.fromkeys(ids.ravel().tolist())]
        hits, misses = self.cache.lookup(keys)
        self.layer_lookups += len(keys)
        self.layer_hits += len(hits)
        return hits, misses

    # -------------------------------------------------------------- resilience
    def _check_health(self):
        """One degradation-ladder step per turn: probe-and-repair the
        prefetch plane and step down to on-demand loading while it is
        unhealthy (recomputed every turn, never latched)."""
        if self.prefetcher.mode == "off":
            self._degraded = False
        else:
            self._degraded = not self.prefetcher.revive()

    def health(self) -> str:
        """``"healthy"``, ``"degraded"`` or ``"failed"`` (worker gone for
        good)."""
        if not self._degraded:
            return "healthy"
        pf = self.prefetcher
        if pf.mode == "worker" and not pf.worker_alive() \
                and pf.worker_restarts >= pf.max_worker_restarts:
            return "failed"
        return "degraded"

    def _load_wave(self, wave: List[ExpertKey], st: DecodeState) -> List[int]:
        """Decode-critical on-demand load of one miss wave under a bounded
        retry budget; the final attempt runs with injected faults
        suppressed.  A real fault that survives every retry raises
        :class:`ExpertLoadError` (``finish_reason="io_error"``)."""
        attempts = self.config.io_retries + 1
        verify = self.prefetcher.verify
        last: Optional[BaseException] = None
        for a in range(attempts):
            calm = self.chaos.calm() if self.chaos is not None \
                and a == attempts - 1 else contextlib.nullcontext()
            try:
                with calm:
                    arrays = self.store.fetch_verified(wave) if verify \
                        else self.store.fetch(wave)
                    return self.cache.insert(wave, arrays, mark_used=True,
                                             stats=st.io)
            except OSError as e:           # ChaosError/PayloadCorruption too
                last = e
                if a < attempts - 1:
                    time.sleep(self.config.retry_backoff_s * (2 ** a))
        self.io_errors += 1
        raise ExpertLoadError(
            f"on-demand load of {len(wave)} experts failed after "
            f"{attempts} attempts: {last}") from last

    def _verify_block(self, tokens: torch.Tensor, pos: int, tcache):
        """Target forward over one verify block with cache-aware expert
        compute.  tokens: [1, N+1].  Session state is read from ``self._st``
        so the signature stays the sync-spy hook tests wrap."""
        st = self._st
        self.verify_blocks += 1
        if st.fast_ok and self.policy != "adapmoe":
            logits, ok, nhist, nact = self._verify_fast(tokens, pos,
                                                        st.slot)
            if bool(self._readback(ok)):          # sync 1 of ≤2 per block
                st.history_dev.copy_(nhist)
                st.fast_active_dev = st.fast_active_dev + nact
                st.fast_blocks += 1
                self.fast_blocks += 1
                return logits, tcache
            st.fast_ok = False                    # mispredicted availability
            st.fast_penalty = 2
            self._fast_hint = False
            self.fast_fallbacks += 1
        return self._verify_block_slow(tokens, pos, tcache)

    def _verify_block_slow(self, tokens: torch.Tensor, pos: int, tcache):
        """Miss resolution: per-layer loop, one routing readback per layer,
        on-demand wave loading; re-arms the session's fast path when the
        whole block resolved from cache."""
        st = self._st
        cfg, tgt, dev = self.cfg, self.target, self.device
        x = tgt.dense_stack(tgt.embed(tokens), tcache, pos)
        T = tokens.shape[1]
        total_misses = 0
        for l in range(self.store.num_layers):
            x, h2 = tgt.attn_half(l, x, tcache["layers"][l], pos)
            w, ids, _ = self._gate(l, h2)
            ids_np = self._readback(ids)          # miss-resolution sync
            act = np.zeros((cfg.num_experts,), np.float32)
            act[np.unique(ids_np)] = 1.0
            st.history_dev[l] += host_to_device(act, dev)
            # AdapMoE baseline: predict the next layer from this layer's gate
            # input with the target's own gates, synchronous prefetch
            if self.policy == "adapmoe" and l + 1 < self.store.num_layers:
                nxt = self.predictor.predict_layer(l + 1, h2[:, -1:])
                _, miss = self.cache.lookup(nxt, touch=False)
                if miss:
                    self._prefetch(st, miss)         # vanilla mode: blocking
            hits, misses = self._ensure_loaded(l, ids_np)
            total_misses += len(misses)
            # cached-first compute: hit experts' slots unmasked, others -1
            slot_lut = np.full((cfg.num_experts,), -1, np.int32)
            for (_, e), s in hits.items():
                slot_lut[e] = s
            xf = h2.reshape(T, cfg.d_model)
            with self.cache.reading() as (bufs, _):
                y = self._moe_apply(bufs, xf,
                                    host_to_device(slot_lut[ids_np], dev), w)
            if misses:
                # on-demand batched loads in cache-capacity-bounded waves;
                # each wave's share is computed before the next streams in
                self.on_demand_loads += len(misses)
                wave_size = max(1, self.cache.num_slots)
                for w0 in range(0, len(misses), wave_size):
                    wave = misses[w0:w0 + wave_size]
                    slots = self._load_wave(wave, st)
                    wave_lut = np.full((cfg.num_experts,), -1, np.int32)
                    for key, s in zip(wave, slots):
                        wave_lut[key[1]] = s
                    with self.cache.reading() as (bufs, _):
                        y = y + self._moe_apply(
                            bufs, xf, host_to_device(wave_lut[ids_np], dev),
                            w)
            x = self._add_moe_out(l, x, h2, y.reshape(1, T, cfg.d_model))
        if self.policy != "adapmoe":
            if total_misses == 0:
                if st.fast_penalty > 0:
                    st.fast_penalty -= 1
                st.fast_ok = st.fast_penalty == 0
            else:
                st.fast_ok = False
            self._fast_hint = st.fast_ok   # seed arming of future sessions
        return tgt.logits(x), tcache

    # ------------------------------------------------------------ session API
    def start_session(self, prompt: torch.Tensor, max_new_tokens: int
                      ) -> DecodeState:
        """Admit one request: take a pool slot for its decode state (reset
        by the prefills) and run the prefill verify block through the
        cache-aware path (its expert loads warm the shared cache).  The
        slot goes back in ``finish_session``, or here if the prefill
        raises."""
        if prompt.shape[0] != 1:
            raise ValueError("requests are batch-1")
        st = DecodeState(
            max_new=max_new_tokens, tcache=None,
            n=self.draft_len,                     # 0 for greedy decode
            fast_active_dev=torch.zeros((), dtype=torch.float32,
                                        device=self.device),
            fast_ok=self._fast_hint and self.policy != "adapmoe")
        if max_new_tokens <= 0:
            st.finished = True
            return st
        st.slot = self.pool.take()
        try:
            st.tcache = st.slot.tcache
            reset_cache(st.tcache)
            st.history_dev = st.slot.history
            st.history_dev.zero_()
            self._st = st
            if st.n > 0:
                _, st.dcache = self.draft.prefill(prompt, self.max_seq,
                                                  cache=st.slot.dcache)
            logits, st.tcache = self._verify_block(prompt, 0, st.tcache)
            st.cur = torch.argmax(logits[:, -1], dim=-1)[:, None]
        except BaseException:
            self.pool.give(st.slot)
            st.slot = None
            st.finished = True
            raise
        st.pos = prompt.shape[1]
        st.emitted_total = 1
        st.pending = [int(st.cur[0, 0])]
        return st

    # sentinel: _turn_early found nothing to deliver — the turn must draft
    # and verify (None is a real return value, "session done")
    _NEEDS_VERIFY = object()

    def _turn_early(self, st: DecodeState):
        if st.finished:
            return None
        if st.pending is not None:             # deliver the prefill token
            chunk, st.pending = st.pending, None
            st.finished = st.emitted_total >= st.max_new
            return chunk
        if st.emitted_total >= st.max_new:
            st.finished = True
            return None
        return self._NEEDS_VERIFY

    def _turn_draft(self, st: DecodeState
                    ) -> Tuple[List[int], torch.Tensor]:
        """Prefetch signal + drafting stage of one turn: MoE-Infinity
        history prefetch, the draft loop with SP-MoE speculative
        prefetching, and the assembled verify block [1, N+1]."""
        if self.policy == "moe-infinity":
            hist = self._readback(st.history_dev)
            for l in range(self.store.num_layers):
                top = np.argsort(-hist[l], kind="stable")[: self.k]
                keys = [(l, int(e)) for e in top]
                # while the fast path is armed it never touches the LRU,
                # so predicted-hot experts carry the recency signal
                _, miss = self.cache.lookup(keys, touch=st.fast_ok)
                if miss:
                    self._prefetch(st, miss)
        drafts: List[int] = []
        toks: List[torch.Tensor] = []
        tok = st.cur
        for i in range(st.n):
            tok, taps = self._draft_step(st, tok, st.pos + i)
            tok = tok.clone()          # the step's output is its next input
            toks.append(tok)
            drafts.append(int(tok[0, 0]))
            if self.policy == "spmoe" and self.cutoff >= 0:
                tap_stack = self._draft_taps_for_moe(taps)
                for l in range(min(self.cutoff + 1, self.store.num_layers)):
                    keys = self.predictor.predict_layer(l, tap_stack[l])
                    _, miss = self.cache.lookup(keys, touch=st.fast_ok)
                    if miss:
                        self._prefetch(st, miss)
        block = torch.cat([st.cur] + toks, dim=1)
        return drafts, block

    def _draft_step(self, st: DecodeState, tok: torch.Tensor, pos: int
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """One draft decode step with taps (the reference's ``_draft_step``
        jit) as the captured step keyed by (slot, flash-decode route) over
        the slot's draft cache: -> (next token [1, 1], taps), valid until
        the next draft step of the slot."""
        d, dcache = self.draft, st.slot.dcache
        contiguous, flash = d.decode_route(dcache, pos, 1)

        def body(t, p):
            lg, taps = d.decode_body(dcache, t, pos, contiguous, True, p)
            return torch.argmax(lg[:, -1], dim=-1)[:, None], taps
        out = self.graphs.run(("draft", st.slot.index, flash), body, tok,
                              pos)
        d.note_written(dcache, pos, 1, contiguous)
        return out

    def _turn_commit(self, st: DecodeState, drafts: List[int],
                     greedy: np.ndarray) -> List[int]:
        """Accept/commit stage: greedy is the verified block's argmax row
        ([N+1] host ints)."""
        cfg = self.config
        N = len(drafts)
        d = np.asarray(drafts, np.int64)
        match = d == greedy[:N]
        n_acc = int(np.cumprod(match.astype(np.int64)).sum())
        emitted = [int(t) for t in d[:n_acc]] + [int(greedy[n_acc])]
        st.cur = torch.full((1, 1), int(greedy[n_acc]), dtype=torch.int64,
                            device=self.device)
        st.pos += n_acc + 1
        self.iterations += 1
        self.drafted += N
        self.accepted += n_acc
        if self.decode == DecodePolicy.SD_ADAPTIVE.value:
            st.n, st.acc_ewma = S.adaptive_next_len(
                N, n_acc, st.acc_ewma, cfg.min_draft_len,
                cfg.max_draft_len, cfg.draft_ewma)
        chunk = emitted[:st.max_new - st.emitted_total]
        st.emitted_total += len(chunk)
        st.finished = st.emitted_total >= st.max_new
        return chunk

    def session_turn(self, st: DecodeState) -> Optional[List[int]]:
        """Advance one session by ONE committed chunk (a round of one:
        ``session_turns([st])``); returns the chunk or None once the session
        has nothing left to emit.  Raises :class:`ExpertLoadError` when an
        expert could not be loaded."""
        (chunk, _, _), = self.session_turns([st])
        if isinstance(chunk, ExpertLoadError):
            raise chunk
        return chunk

    def _counter_delta(self, before: Dict[str, int]) -> Dict[str, int]:
        after = self.counters()
        return {k: after[k] - before[k] for k in RUNTIME_COUNTER_KEYS}

    @staticmethod
    def _merge_delta(into: Dict[str, int], delta: Dict[str, int]):
        for k, v in delta.items():
            into[k] = into.get(k, 0) + v

    def session_turns(self, sts: Sequence[DecodeState]
                      ) -> List[Tuple[Any, Dict[str, int], float]]:
        """Advance SEVERAL sessions by one committed verify block each in one
        scheduling round.  Drafting (and its prefetch submissions) runs per
        session first; then the sessions whose fast path is armed verify
        together (``_round_fused``: one ``cache_moe`` launch per MoE layer,
        ≤2 host syncs for the whole round), and the others verify solo on
        their usual path.  A fused session whose block missed falls back
        ALONE to the slow path; its batchmates commit.

        Returns one ``(chunk, counter_delta, wall_s)`` per session.  A chunk
        is a list of tokens, None (session done) or an ``ExpertLoadError``
        (the session could not load an expert).  ``counter_delta`` is the
        growth of the cumulative counters this session caused (the round's
        two shared syncs are charged to its first fused session), so the
        per-request ledgers add up to the cumulative counters; ``wall_s`` is
        the time of this session's own phases plus an even share of the
        fused dispatch."""
        chunks: List[Any] = [None] * len(sts)
        deltas: List[Dict[str, int]] = [{} for _ in sts]
        walls: List[float] = [0.0] * len(sts)
        pend: List[Tuple[int, DecodeState, List[int], torch.Tensor]] = []
        for i, st in enumerate(sts):
            before = self.counters()
            t0 = time.perf_counter()
            early = self._turn_early(st)
            if early is not self._NEEDS_VERIFY:
                chunks[i] = early
                deltas[i] = self._counter_delta(before)
                walls[i] += time.perf_counter() - t0
                continue
            self._st = st
            if not pend:
                # one ladder step per verifying round, and its degraded
                # tick, inside the first verifying session's delta window
                self._check_health()
                if self._degraded:
                    self.degraded_rounds += 1
            drafts, block = self._turn_draft(st)
            deltas[i] = self._counter_delta(before)
            walls[i] += time.perf_counter() - t0
            pend.append((i, st, drafts, block))
        if pend:
            self.verify_rounds += 1
        fused = [p for p in pend
                 if p[1].fast_ok and self.policy != "adapmoe"]
        if len(fused) >= 2:
            fused_idx = {p[0] for p in fused}
            solo = [p for p in pend if p[0] not in fused_idx]
            self._round_fused(fused, chunks, deltas, walls)
        else:
            solo = pend
        for i, st, drafts, block in solo:
            before = self.counters()
            t0 = time.perf_counter()
            self._st = st
            self.round_launches += 1
            try:
                tlogits, st.tcache = self._verify_block(block, st.pos,
                                                        st.tcache)
                greedy = self._readback(torch.argmax(tlogits, dim=-1))[0]
                chunks[i] = self._turn_commit(st, drafts, greedy)
            except ExpertLoadError as e:
                st.finished = True           # ends only this session
                chunks[i] = e
            self._merge_delta(deltas[i], self._counter_delta(before))
            walls[i] += time.perf_counter() - t0
        return list(zip(chunks, deltas, walls))

    def _round_fused(self, fused, chunks, deltas, walls):
        """The fused leg of a round: one ``_verify_fast_batched`` call over
        every armed session's block, the all-hit vector and the round's
        argmax read back once each, then a commit per hit session and a
        solo slow re-run per session that missed."""
        idxs = [p[0] for p in fused]
        sts = [p[1] for p in fused]
        blocks = [p[3] for p in fused]
        self.round_launches += 1
        t0 = time.perf_counter()
        logits, ok_vec, new_hists, nact_vec = self._verify_fast_batched(
            blocks, [st.pos for st in sts], [st.slot for st in sts])
        ok = self._readback(ok_vec)                          # round sync 1
        greedy = self._readback(torch.cat(
            [torch.argmax(lg, dim=-1) for lg in logits], dim=1))[0]  # sync 2
        shared = (time.perf_counter() - t0) / len(fused)
        for i in idxs:
            walls[i] += shared
        deltas[idxs[0]]["host_syncs"] = \
            deltas[idxs[0]].get("host_syncs", 0) + 2
        off = 0
        for j, (i, st, drafts, block) in enumerate(fused):
            T = block.shape[1]
            before = self.counters()
            t0 = time.perf_counter()
            self._st = st
            self.verify_blocks += 1
            if bool(ok[j]):
                st.history_dev.copy_(new_hists[j])
                st.fast_active_dev = st.fast_active_dev + nact_vec[j]
                st.fast_blocks += 1
                self.fast_blocks += 1
                chunks[i] = self._turn_commit(st, drafts,
                                              greedy[off:off + T])
            else:
                # mispredicted availability: this session falls back alone
                st.fast_ok = False
                st.fast_penalty = 2
                self._fast_hint = False
                self.fast_fallbacks += 1
                self.round_launches += 1
                try:
                    tlogits, st.tcache = self._verify_block_slow(
                        block, st.pos, st.tcache)
                    g = self._readback(torch.argmax(tlogits, dim=-1))[0]
                    chunks[i] = self._turn_commit(st, drafts, g)
                except ExpertLoadError as e:
                    st.finished = True       # its batchmates committed
                    chunks[i] = e
            off += T
            self._merge_delta(deltas[i], self._counter_delta(before))
            walls[i] += time.perf_counter() - t0

    def _prefetch(self, st: DecodeState, keys):
        """Submit a prefetch on behalf of ``st`` (nothing while the ladder
        is degraded: the slow path's on-demand waves carry the load)."""
        if self._degraded:
            return
        task = self.prefetcher.submit(keys)
        if task is not None:
            st.inflight.append(task)

    def finish_session(self, st: DecodeState):
        """Retire a session (idempotent): give its pool slot back, fold its
        device-side fast-hit accumulator into the lookup/hit counters (one
        metrics-plane readback, not counted) and wait out its own prefetch
        tasks.  Every way a session ends comes here (``Engine`` finishes
        a session of every finish reason through it)."""
        if st.committed:
            return
        st.committed = True
        st.finished = True
        if st.slot is not None:
            self.pool.give(st.slot)
            st.slot = None
        if st.fast_blocks:
            fast_active = int(st.fast_active_dev.item())
            self.layer_lookups += fast_active
            self.layer_hits += fast_active
        for task in st.inflight:
            if self.prefetcher.wait_task(
                    task, timeout=self.config.drain_timeout_s):
                for k, v in task.stats.items():
                    st.io[k] = st.io.get(k, 0) + v
        st.inflight.clear()
        self.cache.wait()

    # ---------------------------------------------------------------- generate
    def generate_stream(self, prompt: torch.Tensor, max_new_tokens: int
                        ) -> Iterator[List[int]]:
        """Single-session streaming wrapper: one chunk per committed verify
        block; the session is retired on every exit path."""
        if max_new_tokens <= 0:
            return
        st = self.start_session(prompt, max_new_tokens)
        try:
            while True:
                chunk = self.session_turn(st)
                if chunk is None:
                    return
                yield chunk
        finally:
            self.finish_session(st)

    def generate(self, prompt: torch.Tensor, max_new_tokens: int
                 ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """One-shot wrapper returning (tokens, stats of this call)."""
        before = self.counters()
        t0 = time.perf_counter()
        out: List[int] = []
        for chunk in self.generate_stream(prompt, max_new_tokens):
            out.extend(chunk)
        dt = time.perf_counter() - t0
        d = self._counter_delta(before)
        stats = dict(d, wall_s=dt, tpot_wall=dt / max(len(out), 1),
                     acceptance_rate=d["accepted"] / max(d["drafted"], 1),
                     hit_rate=d["hits"] / max(d["lookups"], 1),
                     cutoff_layer=self.cutoff)
        return torch.tensor(out, dtype=torch.int64), stats

    def counters(self) -> Dict[str, int]:
        """Raw cumulative counters — host-only, never waits on the device."""
        return {
            "lookups": self.layer_lookups,
            "hits": self.layer_hits,
            "on_demand_loads": self.on_demand_loads,
            "prefetched": self.prefetcher.loaded_count,
            "evictions": self.cache.evictions,
            "prefetch_evicted_unused": self.cache.prefetch_evicted,
            "host_syncs": self.host_syncs,
            "verify_blocks": self.verify_blocks,
            "fast_blocks": self.fast_blocks,
            "fast_fallbacks": self.fast_fallbacks,
            "iterations": self.iterations,
            "drafted": self.drafted,
            "accepted": self.accepted,
            "prefetch_errors": self.prefetcher.error_count,
            "prefetch_retries": self.prefetcher.retry_count,
            "checksum_failures": self.store.checksum_failures,
            "worker_restarts": self.prefetcher.worker_restarts,
            "degraded_rounds": self.degraded_rounds,
            "io_errors": self.io_errors,
        }

    def reset_stats(self):
        """Zero the cumulative counters (engine + cache + prefetcher) so a
        warmed engine can report clean steady-state numbers."""
        self.layer_hits = self.layer_lookups = 0
        self.on_demand_loads = self.host_syncs = 0
        self.verify_blocks = self.fast_blocks = self.fast_fallbacks = 0
        self.iterations = self.drafted = self.accepted = 0
        self.verify_rounds = self.round_launches = 0
        self.degraded_rounds = self.io_errors = 0
        self.store.checksum_failures = 0
        self.cache.reset_stats()
        self.prefetcher.reset_stats()

    def _draft_taps_for_moe(self, taps: Dict[str, torch.Tensor]
                            ) -> torch.Tensor:
        """The draft's taps of target MoE layers 0..n-1, as the reference
        maps them.  A dense draft of the target's depth holds every layer
        in ``layers``: its layer l + first_dense_layers predicts MoE layer
        l.  An MoE draft with its own ``dense_layers`` (deepseek's
        self-draft) holds only its MoE layers there, and a shallower draft
        has fewer: layer l predicts MoE layer l."""
        stack = taps["layers"]
        n = self.store.num_layers
        off = self.cfg.first_dense_layers
        if stack.shape[0] >= n + off:
            return stack[off:off + n]
        return stack[:n]

    def close(self):
        self.prefetcher.stop()
