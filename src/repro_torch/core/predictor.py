"""Cross-model expert predictor (paper §3.2, Algorithm 1).  The port of
``repro/core/predictor.py`` (the Observation-I analytics stay with the
reference).

During drafting, the draft model's layer-``l`` gate input (post-attention,
pre-FFN hidden state) is fed through the *target* model's layer-``l`` gating
network; the top-k scored experts are the predicted critical experts for the
upcoming verification of that layer.
"""
from __future__ import annotations

from typing import List

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
