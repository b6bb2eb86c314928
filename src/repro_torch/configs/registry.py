"""``--arch`` id -> ModelConfig registry, trimmed to what the port runs:
mixtral-8x7b and its dense draft (paper Table 1); phi-3.5-moe and its MoE
draft phi-mini-moe (Table 1); deepseek-v2-lite-16b (MLA, one leading dense
layer, shared experts), whose Table 1 draft is the same architecture (an
MoE self-draft); llama3.2-3b, a dense target with tied embeddings served
with all weights resident, greedy or speculatively with the derived
half-depth draft (it has no published draft pairing); and the SSD families:
mamba2-780m (ssm) and zamba2-7b (hybrid), served greedy with all weights
resident.  An MoE draft keeps its experts resident on the device; only the
target's are offloaded."""
from __future__ import annotations

from typing import Dict, Optional

from repro_torch.configs import (deepseek_v2_lite_16b, llama3_2_3b,
                                 mamba2_780m, mixtral_8x7b, phi_3_5_moe,
                                 zamba2_7b)
from repro_torch.configs.base import ModelConfig

ARCHS: Dict[str, ModelConfig] = {
    "mixtral-8x7b": mixtral_8x7b.CONFIG,
    "phi-3.5-moe": phi_3_5_moe.CONFIG,
    "deepseek-v2-lite-16b": deepseek_v2_lite_16b.CONFIG,
    "llama3.2-3b": llama3_2_3b.CONFIG,
    "mamba2-780m": mamba2_780m.CONFIG,
    "zamba2-7b": zamba2_7b.CONFIG,
}

# SP-MoE draft-model pairings (paper Table 1).  The deepseek draft is the
# AWQ-quantized same architecture; a config with the same dims stands in.
DRAFTS: Dict[str, ModelConfig] = {
    "mixtral-8x7b": mixtral_8x7b.DRAFT_CONFIG,
    "phi-3.5-moe": phi_3_5_moe.DRAFT_CONFIG,
    "deepseek-v2-lite-16b": deepseek_v2_lite_16b.CONFIG,
}


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown --arch {arch!r}; known: {sorted(ARCHS)}")
    return ARCHS[arch]


def get_draft_config(arch: str) -> Optional[ModelConfig]:
    return DRAFTS.get(arch)
