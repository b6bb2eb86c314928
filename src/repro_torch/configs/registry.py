"""``--arch`` id -> ModelConfig registry, trimmed to what the port serves:
mixtral-8x7b and its dense draft (paper Table 1)."""
from __future__ import annotations

from typing import Dict, Optional

from repro_torch.configs import mixtral_8x7b
from repro_torch.configs.base import ModelConfig

ARCHS: Dict[str, ModelConfig] = {
    "mixtral-8x7b": mixtral_8x7b.CONFIG,
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
