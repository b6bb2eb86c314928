"""``--arch`` id -> ModelConfig registry, trimmed to what the port runs:
mixtral-8x7b and its dense draft (paper Table 1); phi-3.5-moe and its MoE
draft phi-mini-moe (Table 1); deepseek-v2-lite-16b (MLA, one leading dense
layer, shared experts), whose Table 1 draft is the same architecture (an
MoE self-draft); llama3.2-3b, a dense target with tied embeddings served
with all weights resident, greedy or speculatively with the derived
half-depth draft (it has no published draft pairing), and the other dense
targets of the reference's assigned pool, served the same way:
command-r-35b (swiglu, tied embeddings, vocab 256000), granite-20b (MQA,
a two-matrix gelu FFN) and nemotron-4-340b (head dim 192, a squared-ReLU
FFN); and the SSD families:
mamba2-780m (ssm) and zamba2-7b (hybrid), served greedy with all weights
resident; llava-next-mistral-7b (vlm: a mistral-7b backbone fed
prepended patch embeddings), which the port trains; and whisper-medium
(encdec: 24 encoder + 24 decoder blocks over stubbed frame embeddings),
which the port serves through its own prefill / decode steps and trains.
An MoE draft keeps its experts resident on the device; only the target's
are offloaded."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

from repro_torch.configs import (command_r_35b, deepseek_v2_lite_16b,
                                 granite_20b, llama3_2_3b,
                                 llava_next_mistral_7b, mamba2_780m,
                                 mixtral_8x7b, nemotron_4_340b, phi_3_5_moe,
                                 whisper_medium, zamba2_7b)
from repro_torch.configs.base import ModelConfig

ARCHS: Dict[str, ModelConfig] = {
    "mixtral-8x7b": mixtral_8x7b.CONFIG,
    "phi-3.5-moe": phi_3_5_moe.CONFIG,
    "deepseek-v2-lite-16b": deepseek_v2_lite_16b.CONFIG,
    "llama3.2-3b": llama3_2_3b.CONFIG,
    "command-r-35b": command_r_35b.CONFIG,
    "granite-20b": granite_20b.CONFIG,
    "nemotron-4-340b": nemotron_4_340b.CONFIG,
    "mamba2-780m": mamba2_780m.CONFIG,
    "zamba2-7b": zamba2_7b.CONFIG,
    "llava-next-mistral-7b": llava_next_mistral_7b.CONFIG,
    "whisper-medium": whisper_medium.CONFIG,
}

# The reference's ten assigned architectures: the dry-run and roofline
# matrix (``launch/dryrun.py``); phi-3.5-moe is the paper's extra.
ASSIGNED = ("granite-20b", "command-r-35b", "nemotron-4-340b", "llama3.2-3b",
            "whisper-medium", "llava-next-mistral-7b", "deepseek-v2-lite-16b",
            "mixtral-8x7b", "zamba2-7b", "mamba2-780m")

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


def arch_ids() -> Tuple[str, ...]:
    """The reference's ten assigned architectures, in its order."""
    return tuple(ASSIGNED)
