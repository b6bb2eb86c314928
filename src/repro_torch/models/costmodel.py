"""Analytical parameter counts and byte sizes (the subset the offload
runtime and the cutoff solver need).  All counts are for the whole model.
"""
from __future__ import annotations

from typing import Optional, Tuple

from repro_torch.configs.base import ModelConfig

BYTES = {"bfloat16": 2, "float32": 4}


# ---------------------------------------------------------------------------
# parameter counts
# ---------------------------------------------------------------------------

def _attn_params(cfg: ModelConfig) -> int:
    d, H, Hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    if cfg.use_mla:
        r, rd, vd = cfg.kv_lora_rank, cfg.rope_head_dim, cfg.v_head_dim
        return (d * H * (hd + rd)       # wq
                + d * r + d * rd        # wdkv, wkr
                + r * H * hd + r * H * vd
                + H * vd * d)           # wo
    return d * H * hd + 2 * d * Hkv * hd + H * hd * d


def _ffn_params(cfg: ModelConfig, f: Optional[int] = None) -> int:
    f = cfg.d_ff if f is None else f
    mats = 3 if cfg.ffn_activation == "swiglu" else 2
    return mats * cfg.d_model * f


def _moe_params(cfg: ModelConfig) -> Tuple[int, int]:
    """(per-layer total expert params, per-layer active expert params)."""
    per_expert = 3 * cfg.d_model * cfg.moe_d_ff
    total = cfg.num_experts * per_expert + cfg.d_model * cfg.num_experts
    shared = cfg.num_shared_experts * per_expert
    active = cfg.num_experts_per_tok * per_expert + shared
    return total + shared, active


def _mamba_params(cfg: ModelConfig) -> int:
    d = cfg.d_model
    d_in = cfg.d_inner
    N = cfg.ssm_state_dim
    H = d_in // cfg.ssm_head_dim
    proj = 2 * d_in + 2 * N + H
    conv_ch = d_in + 2 * N
    return (d * proj + cfg.ssm_conv_width * conv_ch + conv_ch
            + 3 * H + d_in + d_in * d)


def expert_param_bytes(cfg: ModelConfig) -> int:
    """One routed expert's bytes (the unit of SP-MoE offloading I/O)."""
    return 3 * cfg.d_model * cfg.moe_d_ff * BYTES[cfg.dtype]


def non_expert_bytes(cfg: ModelConfig) -> int:
    """Resident bytes when all routed experts are offloaded."""
    total, _ = count_params(cfg)
    if cfg.is_moe:
        routed = cfg.num_moe_layers * cfg.num_experts * 3 * cfg.d_model * cfg.moe_d_ff
        return (total - routed) * BYTES[cfg.dtype]
    return total * BYTES[cfg.dtype]


def count_params(cfg: ModelConfig) -> Tuple[int, int]:
    """(total_params, active_params_per_token)."""
    d = cfg.d_model
    emb = cfg.vocab_size * d
    head = 0 if cfg.tie_embeddings else d * cfg.vocab_size
    total = emb + head + d
    active = emb + head + d
    kinds = cfg.layer_kinds()
    shared_attn_counted = False
    for kind in kinds:
        if kind == "mamba":
            p = _mamba_params(cfg) + d
            total += p
            active += p
        elif kind == "moe":
            attn = _attn_params(cfg) + 2 * d
            tot_moe, act_moe = _moe_params(cfg)
            total += attn + tot_moe
            active += attn + act_moe
        else:
            p = _attn_params(cfg) + 2 * d
            f = _ffn_params(cfg)
            if cfg.family == "hybrid":
                if not shared_attn_counted:
                    total += p + f
                    shared_attn_counted = True
                active += p + f
            else:
                total += p + f
                active += p + f
    if cfg.family == "encdec":
        enc = cfg.encoder_layers * (_attn_params(cfg) + _ffn_params(cfg) + 2 * d)
        dec_cross = cfg.num_layers * (_attn_params(cfg) + d)
        total += enc + dec_cross
        active += enc + dec_cross
    return int(total), int(active)
