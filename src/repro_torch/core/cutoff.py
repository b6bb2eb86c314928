"""Cutoff-layer policy (paper §3.2).

Chooses the deepest layer L such that prefetching k experts for every layer
0..L during the drafting stage (a) fits GPU/HBM memory next to the peak
non-expert working set and (b) finishes before drafting ends, whichever of
compute or I/O is the bottleneck:

    N_expert = sum_{i<=L} k_i          (k_i ~= k; cached experts skipped)
    M_peak + N_expert * M_expert < M_GPU
    max((L-1)*t_comp + k_L*t_io,  N_expert*t_io) <= L_all * t_comp_draft * N_draft

The drafting budget on the right-hand side is the *whole drafting stage*
(L_all draft layers × N_draft draft tokens), matching Observation III.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class HardwareProfile:
    """Profiled system characteristics (paper's profiling module)."""
    t_comp: float            # per-layer target compute time (s)
    t_comp_draft: float      # per-layer draft compute time (s)
    t_io: float              # per-expert host->device load time (s)
    mem_gpu: float           # device memory capacity (bytes)
    mem_peak: float          # peak non-expert memory (bytes)
    mem_expert: float        # one expert's parameter bytes


@dataclass(frozen=True)
class CutoffDecision:
    cutoff_layer: int        # L: prefetch layers 0..L (inclusive); -1 = none
    n_experts: int           # total experts prefetched per iteration
    memory_bound: bool       # which constraint was binding
    overlap_bound: bool
    draft_budget: float      # drafting-stage time available for prefetch (s)
    io_time: float           # I/O time consumed at the chosen L (s)


def solve_cutoff(profile: HardwareProfile, k: int, num_layers: int,
                 draft_len: int, draft_layers: Optional[int] = None
                 ) -> CutoffDecision:
    """Maximize L subject to the paper's two constraints (k_i ~= k)."""
    draft_layers = draft_layers if draft_layers is not None else num_layers
    budget = draft_layers * profile.t_comp_draft * max(draft_len, 1)
    best = CutoffDecision(-1, 0, False, False, budget, 0.0)
    mem_free = profile.mem_gpu - profile.mem_peak
    for L in range(num_layers):
        n_expert = (L + 1) * k
        mem_ok = n_expert * profile.mem_expert < mem_free
        io_time = n_expert * profile.t_io
        pipelined = max((L - 1) * profile.t_comp_draft + k * profile.t_io, io_time)
        overlap_ok = pipelined <= budget
        if mem_ok and overlap_ok:
            best = CutoffDecision(L, n_expert, False, False, budget, io_time)
        else:
            return CutoffDecision(best.cutoff_layer, best.n_experts,
                                  not mem_ok, not overlap_ok, budget,
                                  best.io_time)
    return best


def profile_from_model(cfg, bandwidth_gbps: float = 32.0,
                       t_comp: float = 3e-3, t_comp_draft: float = 1.5e-3,
                       mem_gpu: float = 24e9,
                       mem_peak: Optional[float] = None) -> HardwareProfile:
    """Derive a HardwareProfile from a ModelConfig + link bandwidth.

    Defaults mirror the paper's RTX-4090/PCIe-4.0 profile.
    """
    from repro_torch.models.costmodel import expert_param_bytes, non_expert_bytes
    m_exp = expert_param_bytes(cfg)
    m_peak = mem_peak if mem_peak is not None else non_expert_bytes(cfg)
    return HardwareProfile(
        t_comp=t_comp, t_comp_draft=t_comp_draft,
        t_io=m_exp / (bandwidth_gbps * 1e9),
        mem_gpu=mem_gpu, mem_peak=m_peak, mem_expert=m_exp)
