"""``--arch`` id -> ModelConfig registry, trimmed to what the port runs:
mixtral-8x7b and its dense draft (paper Table 1); llama3.2-3b, a dense
target with tied embeddings served with all weights resident, greedy or
speculatively with the derived half-depth draft (``derive_draft_config``;
it has no published draft pairing); and the SSD families: mamba2-780m (ssm)
and zamba2-7b (hybrid), served greedy with all weights resident."""
from __future__ import annotations

from typing import Dict, Optional

from repro_torch.configs import (llama3_2_3b, mamba2_780m, mixtral_8x7b,
                                 zamba2_7b)
from repro_torch.configs.base import ModelConfig

ARCHS: Dict[str, ModelConfig] = {
    "mixtral-8x7b": mixtral_8x7b.CONFIG,
    "llama3.2-3b": llama3_2_3b.CONFIG,
    "mamba2-780m": mamba2_780m.CONFIG,
    "zamba2-7b": zamba2_7b.CONFIG,
}

# SP-MoE draft-model pairings (paper Table 1).
DRAFTS: Dict[str, ModelConfig] = {
    "mixtral-8x7b": mixtral_8x7b.DRAFT_CONFIG,
}


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown --arch {arch!r}; known: {sorted(ARCHS)}")
    return ARCHS[arch]


def get_draft_config(arch: str) -> Optional[ModelConfig]:
    return DRAFTS.get(arch)
