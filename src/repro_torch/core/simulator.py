"""Event-driven latency simulator for SD-enabled MoE offloading: the
paper's TPOT model of the baselines across environments (the calibrated
analytical model the paper builds in §3.2), numpy only.  The port's own
copy of ``repro/core/simulator.py``, unchanged but for this paragraph, so
that both give the same result for the same seed.  Its environments are the
paper's (Table 2); none of them is the H100 the port runs on.

Two resources with their own timelines: COMPUTE (device) and IO (host->device
link).  A decode iteration simulates:

  drafting      N draft tokens × L_draft layers of draft compute; the IO
                stream is otherwise idle, so prefetch tasks issued by the
                policy run concurrently (SP-MoE / MoE-Infinity).
  verification  per target layer: attention compute, then expert FFN compute,
                which cannot start before the layer's activated experts have
                ARRIVED (per-key arrival times; in-flight prefetches are
                waited on just-in-time); missing experts are loaded on demand,
                queued FIFO behind outstanding prefetch I/O (bandwidth
                contention, Observation II).

Activations are sampled from per-layer Zipf popularity with token-to-token
overlap (Observation I) and cross-model predictor accuracy (Fig. 7b).

Hit-rate accounting matches Table 3: per verification block, each UNIQUE
activated expert counts one lookup; a hit means it was resident (or in
flight) BEFORE the block's own on-demand loads.

Baseline fidelity:
  on-demand      Mixtral-Offloading: per-layer partitioned LRU rings (the
                 original system caches a fixed number of experts per layer).
  moe-infinity   request-level, history-ranked prefetch, depth-unbounded but
                 budget-capped; refreshed each iteration (over-prefetch
                 pollutes the cache and contends for bandwidth).
  adapmoe        same-model gating predicts ONE expert of layer l+1 after
                 layer l's gate; synchronous (vanilla) prefetch stalls.
  spmoe          drafting-stage cross-model prefetch for layers 0..cutoff,
                 async worker + batched I/O + LRU.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclass
class SimModel:
    """Calibration constants for one draft/target pair (paper Table 1 + §5)."""
    name: str
    num_layers: int
    num_experts: int
    top_k: int                 # experts activated per token per layer
    k_prefetch: int            # paper's critical-expert count (k in Alg. 1)
    expert_mb: float           # one expert's weight bytes (MB)
    t_comp_attn: float         # target per-layer attention+gate compute (s)
    t_comp_expert: float       # target per-expert FFN compute (s)
    t_comp_draft_layer: float  # draft per-layer compute (s)
    acceptance: float          # draft acceptance rate (Table 1 AC)
    predictor_acc: float       # cross-model top-k prediction accuracy (Fig 7b)
    zipf_a: float = 1.2        # expert popularity skew
    shared_experts: int = 0    # always-resident shared experts (deepseek)
    non_expert_gb: float = 5.0 # resident non-expert + draft + KV footprint


# Calibration: RTX-4090-class compute, PCIe 4.0x16 link (paper Table 2 env 2).
# Expert sizes / per-expert load times follow §2.2, §5.1 (336 MB -> ~14 ms,
# 150 MB -> ~6 ms, 16.5 MB -> ~0.6 ms at ~24 GB/s effective).
# Per-layer compute and drafting times are set so a baseline iteration
# splits ~69% expert loading / ~16% drafting / ~15% compute (paper Fig. 4).
MIXTRAL = SimModel("mixtral-8x7b", 32, 8, 2, 1, 336.0,
                   t_comp_attn=2.5e-3, t_comp_expert=2.0e-3,
                   t_comp_draft_layer=7.3e-3, acceptance=0.9742,
                   predictor_acc=0.88, zipf_a=0.7, non_expert_gb=5.0)
PHI_MOE = SimModel("phi-3.5-moe", 32, 16, 2, 2, 150.0,
                   t_comp_attn=1.2e-3, t_comp_expert=8.0e-4,
                   t_comp_draft_layer=2.4e-3, acceptance=0.9013,
                   predictor_acc=0.88, zipf_a=0.7, non_expert_gb=4.5)
DEEPSEEK = SimModel("deepseek-v2-lite-16b", 26, 64, 6, 6, 16.5,
                    t_comp_attn=1.0e-3, t_comp_expert=1.2e-4,
                    t_comp_draft_layer=2.5e-3, acceptance=0.9701,
                    predictor_acc=0.8894, zipf_a=0.7, non_expert_gb=7.0)
SIM_MODELS = {m.name: m for m in (MIXTRAL, PHI_MOE, DEEPSEEK)}


@dataclass
class SimEnv:
    """Hardware environment (paper Table 2)."""
    name: str
    pcie_gbps: float           # effective host->device bandwidth
    compute_scale: float       # device time multiplier vs the 4090 baseline
    gpu_mem_gb: float


ENVS = {
    "3090": SimEnv("3090", 22.0, 1.45, 24.0),
    "4090": SimEnv("4090", 24.0, 1.00, 24.0),
    "a100": SimEnv("a100", 24.0, 0.75, 40.0),
}

# dataset -> (zipf skew multiplier, overlap) — code tasks are more skewed
# (Fig. 9: HumanEval benefits most).
DATASETS = {
    "humaneval": (1.15, 0.78),
    "bigbench": (0.95, 0.70),
    "wikitext103": (0.85, 0.66),
    "mmlu_pro": (1.00, 0.72),
}

# Per-task submission and stream-synchronization overheads.  These are large
# in Transformers/PyTorch offloading stacks (allocator + python + cudaStream
# sync per expert — cf. Hobbit [37]: 336 MB expert = 10.5 ms theoretical PCIe
# vs ~14 ms measured, plus multi-ms per-call sync); batched I/O (§3.3) exists
# precisely to amortize them.
IO_LAUNCH_OVERHEAD = 1.5e-3    # per I/O task submission overhead (s)
SYNC_OVERHEAD = 8.0e-3         # per-task stream-sync stall, unbatched path (s)
CACHE_MEM_FRACTION = 0.45      # device memory share usable as expert cache
MI_BUDGET_FRACTION = 0.60      # MoE-Infinity prefetch budget (of cache slots)
CUTOFF_CACHE_FRACTION = 0.75   # SP-MoE: prefetch footprint cap (of slots)


@dataclass
class SimConfig:
    policy: str = "spmoe"      # spmoe | adapmoe | moe-infinity | on-demand
    draft_len: int = 1
    cutoff: Optional[int] = None       # None -> analytical solve
    cache_experts: Optional[int] = None  # slots; None -> from memory budget
    gpu_mem_gb: Optional[float] = None
    batched_io: bool = True
    worker_prefetch: bool = True       # False -> vanilla (sync) prefetch
    drafting_prefetch: bool = True     # False -> disable SP-MoE draft-stage PF
    seed: int = 0
    dataset: str = "humaneval"
    out_tokens: int = 100
    sd_enabled: bool = True


@dataclass
class SimResult:
    tpot: float
    hit_rate: float
    io_time: float
    compute_time: float
    draft_time: float
    evictions: int
    prefetched: int
    prefetch_wasted: int
    cutoff: int
    acceptance: float
    tokens: int


class _LRU:
    """LRU of (layer, expert) keys.

    * ``per_layer=True``   fixed per-layer rings (Mixtral-Offloading's design)
    * ``reserved_per_layer=r``  SP-MoE's stabilized caching (§3.2: "we reserve
      a fixed number of experts per layer"): each layer owns ``r`` protected
      slots for prefetched experts; the remainder is a global LRU pool.
    """

    def __init__(self, slots: int, num_layers: int, per_layer: bool = False,
                 reserved_per_layer: int = 0, reserved_layers: int = 0):
        self.per_layer = per_layer
        self.num_layers = num_layers
        self.slots = slots
        self.layer_slots = max(1, slots // num_layers)
        self.od: "OrderedDict[Tuple[int,int], int]" = OrderedDict()
        self.per_layer_od: List[OrderedDict] = [OrderedDict()
                                                for _ in range(num_layers)]
        self.reserved = reserved_per_layer
        # rings are physical: they cannot overcommit the slot pool.  Layers
        # past ring_layers get no protection — their prefetches land in the
        # (small) pool and thrash it (Fig. 3: eviction rate vs prefetch depth)
        self.ring_layers = (min(reserved_layers,
                                int(slots * 0.9) // max(reserved_per_layer, 1))
                            if reserved_per_layer else 0)
        self.reserved_layers = reserved_layers
        self.pool_slots = max(1, slots - self.reserved * self.ring_layers)
        self.pinned: set = set()
        self.evictions = 0
        self.wasted = 0

    def pin(self, key):
        self.pinned.add(key)

    def unpin_all(self):
        self.pinned.clear()

    def __contains__(self, key):
        if self.per_layer:
            return key[1] in self.per_layer_od[key[0]]
        return key in self.od or (self.reserved and
                                  key[1] in self.per_layer_od[key[0]])

    def __len__(self):
        n = sum(len(od) for od in self.per_layer_od)
        return n + len(self.od)

    def touch(self, key):
        if (self.per_layer or self.reserved) and key[1] in self.per_layer_od[key[0]]:
            od = self.per_layer_od[key[0]]
            od.move_to_end(key[1])
            od[key[1]] = 1
            return
        if key in self.od:
            self.od.move_to_end(key)
            self.od[key] = 1

    def insert(self, key, used=0, protected=False):
        """protected=True -> into the layer's reserved ring (prefetches)."""
        if key in self:
            self.touch(key)
            return
        if self.per_layer or (protected and self.reserved
                              and key[0] < self.ring_layers):
            od = self.per_layer_od[key[0]]
            cap = self.layer_slots if self.per_layer else self.reserved
            if len(od) >= cap:
                _, u = od.popitem(last=False)
                self.evictions += 1
                if not u:
                    self.wasted += 1
            od[key[1]] = used
            return
        # global pool; eviction skips pinned entries (MoE-Infinity hot set)
        while len(self.od) >= self.pool_slots:
            for cand in self.od:
                if cand not in self.pinned:
                    u = self.od.pop(cand)
                    self.evictions += 1
                    if not u:
                        self.wasted += 1
                    break
            else:
                break                         # everything pinned: overflow
        self.od[key] = used


class Simulator:
    def __init__(self, model: SimModel, env: SimEnv, sim: SimConfig):
        self.m, self.env, self.cfg = model, env, sim
        self.rng = np.random.default_rng(sim.seed)
        zipf_mult, overlap = DATASETS[sim.dataset]
        ranks = np.arange(1, model.num_experts + 1, dtype=np.float64)
        base = ranks ** (-model.zipf_a * zipf_mult)
        self.popularity = np.stack([
            self.rng.permutation(base / base.sum())
            for _ in range(model.num_layers)])
        self.overlap = overlap
        self.t_io = model.expert_mb * 1e-3 / env.pcie_gbps   # s per expert
        self.t_attn = model.t_comp_attn * env.compute_scale
        self.t_exp = model.t_comp_expert * env.compute_scale
        self.t_draft = model.t_comp_draft_layer * env.compute_scale
        mem = sim.gpu_mem_gb if sim.gpu_mem_gb is not None else env.gpu_mem_gb
        if sim.cache_experts is not None:
            slots = sim.cache_experts
        else:
            free = max(mem - model.non_expert_gb, 0.5) * CACHE_MEM_FRACTION
            slots = int(max(model.top_k, free * 1024 / model.expert_mb))
        slots = min(slots, model.num_layers * model.num_experts)
        self.slots = slots
        cutoff = sim.cutoff if sim.cutoff is not None else self._auto_cutoff()
        self.cutoff = cutoff
        # SP-MoE reserves k slots per prefetched layer (cache stabilization);
        # on-demand (Mixtral-Offloading) uses fixed per-layer rings.
        self.lru = _LRU(
            slots, model.num_layers,
            per_layer=(sim.policy == "on-demand"),
            reserved_per_layer=(model.k_prefetch
                                if sim.policy == "spmoe" else 0),
            reserved_layers=(cutoff + 1 if sim.policy == "spmoe" else 0))
        self.arrival: Dict[Tuple[int, int], float] = {}
        self.prev_pick: Dict[int, np.ndarray] = {}
        self.pending: Dict[int, np.ndarray] = {}
        self.history = np.zeros((model.num_layers, model.num_experts))
        self.hits = 0
        self.lookups = 0

    # ----------------------------------------------------- activation sampling
    def _sample_tokens(self, layer: int, n_tokens: int) -> np.ndarray:
        """[n_tokens, top_k] expert picks with neighbouring-token overlap."""
        m = self.m
        out = np.zeros((n_tokens, m.top_k), np.int64)
        prev = self.prev_pick.get(layer)
        for t in range(n_tokens):
            if prev is not None and self.rng.random() < self.overlap:
                pick = prev
            else:
                pick = self.rng.choice(m.num_experts, size=m.top_k,
                                       replace=False, p=self.popularity[layer])
            out[t] = pick
            prev = pick
        self.prev_pick[layer] = prev
        self.history[layer][np.unique(out)] += 1
        return out

    def _predict(self, layer: int, actual_block: np.ndarray) -> List[int]:
        """Cross-model prediction of the block's critical experts."""
        m = self.m
        crit = list(dict.fromkeys(actual_block.ravel().tolist()))[: m.k_prefetch]
        preds = []
        for e in crit:
            if self.rng.random() < m.predictor_acc:
                preds.append(int(e))
            else:
                p = self.popularity[layer].copy()
                p[np.unique(actual_block)] = 0
                s = p.sum()
                preds.append(int(self.rng.choice(m.num_experts, p=p / s))
                             if s > 0 else int(e))
        return list(dict.fromkeys(preds))

    # --------------------------------------------------------------- helpers
    def _resident(self, layer: int, e: int) -> bool:
        # (shared experts are always device-resident and never sampled here:
        # lookups cover the ROUTED experts only)
        return (layer, int(e)) in self.lru

    def _io(self, n_experts: int, n_tasks: int, sync: bool = False) -> float:
        dur = n_experts * self.t_io + n_tasks * IO_LAUNCH_OVERHEAD
        if sync:
            # stream-sync stall grows with transfer size (alloc + copy split);
            # floor for tiny experts
            dur += n_tasks * max(2.0e-3, SYNC_OVERHEAD * self.m.expert_mb / 336.0)
        return dur

    # ------------------------------------------------------------------- run
    #
    # I/O is modeled as a single link with TWO priorities: on-demand loads
    # are urgent and preempt queued background prefetch; background segments
    # (each = one batched prefetch task, tagged with the layer it serves)
    # drain whenever the link would otherwise idle, and are force-drained
    # before their layer's verification (they count as hits with a
    # just-in-time arrival wait).  This matches the asynchronous worker +
    # dedicated transfer stream of §3.3.
    def _drain_background(self, upto_layer: int, now: float) -> None:
        """Run background segments that must complete (layer <= upto_layer)
        or that would have started in link-idle time before `now`."""
        while self._bg:
            seg_layer, dur, keys, issue_at = self._bg[0]
            start = max(self._io_done, issue_at)
            if seg_layer <= upto_layer or start < now:
                self._io_done = start + dur
                for k in keys:
                    self.arrival[k] = self._io_done
                self._bg.pop(0)
            else:
                break

    def _bg_submit(self, layer: int, dur: float, keys, issue_at: float):
        self._bg.append((layer, dur, keys, issue_at))

    def run(self) -> SimResult:
        m, cfg = self.m, self.cfg
        N = cfg.draft_len if cfg.sd_enabled else 0
        cutoff = self.cutoff
        now = 0.0
        self._io_done = 0.0          # link busy until (absolute)
        self._bg: List[tuple] = []   # background prefetch segments
        io_time = compute_time = draft_time = 0.0
        prefetched = 0
        tokens_out = 0
        # Fig. 2b's overlap is WITHIN a draft block (neighbouring tokens);
        # across iterations the activation pattern drifts much harder, which
        # is what keeps purely-reactive caches (MO/MI) at ~15% hit (Table 3).
        drift = 0.85
        while tokens_out < cfg.out_tokens:
            for l in list(self.prev_pick.keys()):
                if self.rng.random() < drift:
                    self.prev_pick.pop(l)
            # ---------------- drafting stage ----------------
            draft_dur = N * m.num_layers * self.t_draft
            if cfg.sd_enabled and cfg.policy == "spmoe" and cfg.drafting_prefetch:
                for l in range(min(cutoff + 1, m.num_layers)):
                    block = self._sample_tokens(l, N + 1)
                    self.pending[l] = block
                    preds = self._predict(l, block)
                    new = [e for e in preds if not self._resident(l, e)]
                    if not new:
                        continue
                    # task issued when draft layer l completes (Algorithm 1)
                    issue_at = now + (l / max(m.num_layers, 1)) * draft_dur
                    dur = self._io(len(new), 1 if cfg.batched_io else len(new),
                                   sync=not cfg.worker_prefetch)
                    if not cfg.worker_prefetch:
                        draft_dur += dur          # vanilla PF blocks compute
                    io_time += dur
                    prefetched += len(new)
                    keys = [(l, e) for e in new]
                    for e in new:
                        self.lru.insert((l, e), used=0, protected=True)
                    self._bg_submit(l, dur, keys, issue_at)
            elif cfg.policy == "moe-infinity":
                # request-level, history-ranked, budget-capped prefetch;
                # depth-unbounded greedy tasks (Observation II)
                budget = min(int(self.lru.slots * MI_BUDGET_FRACTION),
                             m.num_layers * m.k_prefetch)
                score = self.history + self.popularity      # [L, E]
                order = np.dstack(np.unravel_index(
                    np.argsort(-score, axis=None), score.shape))[0]
                todo = []
                self.lru.unpin_all()
                for l, e in order[:budget]:
                    key = (int(l), int(e))
                    self.lru.pin(key)         # hot set stays resident
                    if not self._resident(int(l), int(e)):
                        todo.append(key)
                if todo:
                    # greedy per-layer tasks (Observation II: excessive task
                    # generation, no batching across layers)
                    n_tasks = len({k[0] for k in todo})
                    dur = self._io(len(todo), n_tasks)
                    io_time += dur
                    prefetched += len(todo)
                    for key in todo:
                        self.lru.insert(key, used=0)
                    # MoE-Infinity is SD-agnostic: tasks are not layer-phased,
                    # so they sit ahead of on-demand traffic (layer -1 =
                    # drain before anything else -> bandwidth contention).
                    self._bg_submit(-1, dur, todo, now)
                    self._drain_background(-1, now)
            now += draft_dur
            draft_time += draft_dur
            # ---------------- verification stage ----------------
            for l in range(m.num_layers):
                block = self.pending.pop(l, None)
                if block is None:
                    block = self._sample_tokens(l, N + 1)
                now += self.t_attn
                compute_time += self.t_attn
                # background prefetch for this layer must land; idle-time
                # segments for deeper layers drain opportunistically
                self._drain_background(l, now)
                # lookups: unique activated experts, resident-before-block
                uniq = list(dict.fromkeys(block.ravel().tolist()))
                missing: List[int] = []
                wait_until = now
                for e in uniq:
                    self.lookups += 1
                    if self._resident(l, int(e)):
                        self.hits += 1
                        self.lru.touch((l, int(e)))
                        wait_until = max(wait_until,
                                         self.arrival.pop((l, int(e)), now))
                    else:
                        missing.append(int(e))
                now = wait_until                 # just-in-time arrival wait
                if missing:                      # on-demand: urgent priority
                    if cfg.policy == "on-demand":
                        # vanilla offloading: per-expert synchronous copies
                        dur = self._io(len(missing), len(missing), sync=True)
                    else:
                        dur = self._io(len(missing),
                                       1 if cfg.batched_io else len(missing))
                    start = max(now, self._io_done)
                    self._io_done = start + dur
                    io_time += dur
                    now = self._io_done          # FFN waits for its weights
                    for e in missing:
                        self.lru.insert((l, e), used=1)
                # AdapMoE: gate of layer l predicts ONE expert of l+1,
                # prefetched while this layer's FFN computes; the stream sync
                # stalls at the l+1 boundary if unfinished (§3.3, Fig. 8)
                if cfg.policy == "adapmoe" and l + 1 < m.num_layers:
                    blk_next = self._sample_tokens(l + 1, N + 1)
                    self.pending[l + 1] = blk_next
                    preds = self._predict(l + 1, blk_next)[:1]
                    new = [e for e in preds if not self._resident(l + 1, e)]
                    if new:
                        dur = self._io(len(new), len(new))
                        io_time += dur
                        prefetched += len(new)
                        for e in new:
                            self.lru.insert((l + 1, e), used=0)
                        self._bg_submit(l + 1, dur, [(l + 1, e) for e in new],
                                        now)
                        now += 2.0e-3          # stream sync at layer boundary
                exp_t = len(uniq) * self.t_exp
                now += exp_t
                compute_time += exp_t
            self._drain_background(m.num_layers, now)   # finish leftovers
            # ---------------- acceptance ----------------
            if cfg.sd_enabled and N > 0:
                n_acc = int(np.sum(np.cumprod(
                    self.rng.random(N) < m.acceptance)))
                tokens_out += n_acc + 1
            else:
                tokens_out += 1
        return SimResult(
            tpot=now / max(tokens_out, 1),
            hit_rate=self.hits / max(self.lookups, 1),
            io_time=io_time, compute_time=compute_time, draft_time=draft_time,
            evictions=self.lru.evictions, prefetched=prefetched,
            prefetch_wasted=self.lru.wasted, cutoff=cutoff,
            acceptance=self.m.acceptance, tokens=tokens_out)

    def _auto_cutoff(self) -> int:
        """Cache-pressure-bounded cutoff: prefetching deeper than the cache
        can hold causes eviction thrash (Observation II / Fig. 3), so cap the
        prefetch footprint to a fraction of the slots.  With in-order I/O the
        just-in-time constraint is dominated by this capacity bound (§3.2
        discussion; matches the empirical optimum of Fig. 14)."""
        m = self.m
        by_mem = int(CUTOFF_CACHE_FRACTION * self.slots / m.k_prefetch) - 1
        return max(0, min(m.num_layers - 1, by_mem))


def simulate(model_name: str, env_name: str = "4090", **overrides) -> SimResult:
    cfg = SimConfig(**overrides)
    return Simulator(SIM_MODELS[model_name], ENVS[env_name], cfg).run()
