"""Cross-model expert predictor (paper §3.2, Algorithm 1).  The port of
``repro/core/predictor.py``.

During drafting, the draft model's layer-``l`` gate input (post-attention,
pre-FFN hidden state) is fed through the *target* model's layer-``l`` gating
network; the top-k scored experts are the predicted critical experts for the
upcoming verification of that layer.

Also provides the entropy analytics behind Observation I (Figure 2c): the
entropy of the predicted activation distribution under the random /
coarse-grained (MoE-Infinity) / gating-based strategies, numpy copies of
the reference's.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.cache import ExpertKey


class ExpertPredictor:
    """Holds the target model's per-layer gate weights; scores draft taps."""

    def __init__(self, cfg: ModelConfig, target, k_prefetch: int):
        self.cfg = cfg
        self.k = k_prefetch
        # stacked gates of the target's MoE layers: [L_moe, d, E] (f32)
        self.gates = torch.stack([blk.moe.gate for blk in target.layers
                                  if blk.kind == "moe"])
        self.num_layers = self.gates.shape[0]

    def predict_layer(self, layer: int, tap: torch.Tensor
                      ) -> List[ExpertKey]:
        """tap: [B, 1, d] draft gate-input for layer ``layer`` -> predicted
        critical experts of the corresponding target layer (reads the ids
        back to the host, as the reference does)."""
        h = tap.reshape(-1, tap.shape[-1]).float()
        probs = torch.softmax(h @ self.gates[layer], dim=-1)
        ids = torch.topk(probs, self.k, dim=-1).indices.reshape(-1).tolist()
        uniq = list(dict.fromkeys(ids))
        return [(layer, e) for e in uniq[: self.k]]

    def predict_all(self, taps: torch.Tensor, cutoff: int
                    ) -> List[ExpertKey]:
        """taps: [L, B, 1, d] (one draft step) -> predictions for layers
        0..cutoff, shallow layers first (just-in-time ordering)."""
        out: List[ExpertKey] = []
        for layer in range(min(cutoff + 1, self.num_layers, taps.shape[0])):
            out.extend(self.predict_layer(layer, taps[layer]))
        return out


# ---------------------------------------------------------------------------
# Observation I analytics (Figure 2)
# ---------------------------------------------------------------------------

def entropy(p: np.ndarray, axis: int = -1) -> np.ndarray:
    p = np.clip(p, 1e-12, 1.0)
    p = p / p.sum(axis=axis, keepdims=True)
    return -(p * np.log2(p)).sum(axis=axis)


def strategy_entropies(gate_probs: np.ndarray, history_counts: np.ndarray
                       ) -> Dict[str, float]:
    """gate_probs: [T, E] actual per-token gate distributions;
    history_counts: [E] historical activation counts (MoE-Infinity proxy).

    Returns mean entropy of the three prediction strategies of Fig. 2c.
    """
    T, E = gate_probs.shape
    rand = np.full((E,), 1.0 / E)
    hist = history_counts / max(history_counts.sum(), 1e-9)
    return {
        "random": float(entropy(rand)),
        "coarse_grained": float(entropy(hist)),
        "gating_based": float(entropy(gate_probs).mean()),
    }


def activation_overlap(ids_a: np.ndarray, ids_b: np.ndarray) -> float:
    """Fraction of overlap between two tokens' expert sets (Fig. 2b)."""
    a, b = set(ids_a.tolist()), set(ids_b.tolist())
    return len(a & b) / max(len(a | b), 1)
