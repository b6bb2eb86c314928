"""Analytical cost model: parameters, FLOPs, HBM bytes and collective
bytes per (arch x shape x mesh).  The port of ``repro/models/costmodel.py``,
formula for formula.

All counts are GLOBAL (the whole step across the cluster); the roofline
divides by the chip count.  The one intended difference is the default
peaks of ``roofline_terms``: the reference's are a TPU's, these are the
card's, from the NVIDIA H100 80GB HBM3 (SXM5) datasheet at a 700 W power
limit (the card ``nvidia-smi --query-gpu=name,power.limit`` reports in
PERF.md): 989e12 dense bf16 FLOP/s (tensor cores, no sparsity), 3.35e12
B/s of HBM3, and 450e9 B/s of NVLink 4 in each direction (900 GB/s
bidirectional) as the single collective bandwidth, as the reference keeps
one.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.optim.grad_compress import compressed_bytes_fraction

BYTES = {"bfloat16": 2, "float32": 4}

# NVIDIA H100 80GB HBM3 (SXM5) datasheet, 700 W: dense bf16 tensor-core
# FLOP/s, HBM3 bytes/s, NVLink 4 bytes/s in each direction
H100_BF16_FLOPS = 989e12
H100_HBM_BW = 3.35e12
H100_NVLINK_BW = 450e9


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


# ---------------------------------------------------------------------------
# FLOPs (training fwd+bwd = 3x fwd matmul flops; fwd = 2 * active params
# per token + attention quadratic term)
# ---------------------------------------------------------------------------

def _attn_flops_per_layer(cfg: ModelConfig, seq_q: int, seq_kv: int,
                          batch: int) -> int:
    """Score+context matmul FLOPs for one attention layer (full block)."""
    if cfg.family == "ssm":
        return 0
    H, hd = cfg.num_heads, cfg.head_dim
    if cfg.use_mla:
        # absorbed decode dims differ but the full-seq path dominates costs
        hd = cfg.head_dim + cfg.rope_head_dim
    win = cfg.sliding_window
    eff_kv = min(seq_kv, win) if win else seq_kv
    if seq_q == seq_kv:   # causal full pass: ~half the square
        pair = (seq_q * eff_kv // 2 if not win or seq_q > win
                else seq_q * seq_q // 2)
    else:
        pair = seq_q * eff_kv
    return 2 * 2 * batch * H * pair * hd


def _n_attn_layers(cfg: ModelConfig) -> int:
    return sum(1 for k in cfg.layer_kinds() if k != "mamba")


def _ssd_flops_per_layer(cfg: ModelConfig, seq: int, batch: int) -> int:
    d_in = cfg.d_inner
    H = d_in // cfg.ssm_head_dim
    N = cfg.ssm_state_dim
    Q = cfg.ssm_chunk
    P_ = cfg.ssm_head_dim
    nc = max(seq // Q, 1)
    # CB [Q,Q] + (CB.L)@X + state build/apply per chunk per head
    per_chunk = 2 * Q * Q * N + 2 * Q * Q * P_ + 2 * 2 * Q * N * P_
    return batch * H * nc * per_chunk


def step_flops(cfg: ModelConfig, shape: ShapeConfig,
               remat: Optional[bool] = None,
               capacity_factor: Optional[float] = None) -> Dict[str, float]:
    """Global FLOPs for one step of this (arch, shape) cell.

    ``useful`` follows the PaLM MFU convention: parameter matmuls + attention
    dot products at fwd=1x / train=3x.  ``total`` adds the real overheads:
    full per-layer remat recompute (train: +1 fwd pass) and MoE
    capacity-factor padding waste (train routing path).
    """
    B = shape.global_batch
    remat = cfg.remat if remat is None else remat
    cf = cfg.capacity_factor if capacity_factor is None else capacity_factor
    _, active = count_params(cfg)
    if shape.kind == "decode":
        tokens = B  # one new token per sequence
        matmul = 2 * active * tokens
        attn = sum(_attn_flops_per_layer(cfg, 1, shape.seq_len, B)
                   for k in cfg.layer_kinds() if k != "mamba")
        ssd = sum(2 * 2 * (cfg.d_inner // cfg.ssm_head_dim) * cfg.ssm_head_dim
                  * cfg.ssm_state_dim * B
                  for k in cfg.layer_kinds() if k == "mamba")
        if cfg.family == "encdec":
            attn += cfg.num_layers * _attn_flops_per_layer(
                cfg, 1, cfg.encoder_seq, B)
        total = matmul + attn + ssd
        return {"total": float(total), "useful": float(total),
                "matmul": float(matmul), "attn": float(attn + ssd),
                "tokens": float(tokens)}
    tokens = B * shape.seq_len
    matmul = 2 * active * tokens
    # MoE capacity-factor waste (train routing pads each expert to capacity)
    moe_waste = 0.0
    if cfg.is_moe and shape.kind == "train" and cf > 1.0:
        per_tok_expert = (cfg.num_experts_per_tok * 3 * cfg.d_model *
                          cfg.moe_d_ff * cfg.num_moe_layers)
        moe_waste = 2 * per_tok_expert * tokens * (cf - 1.0)
    attn = sum(_attn_flops_per_layer(cfg, shape.seq_len, shape.seq_len, B)
               for k in cfg.layer_kinds() if k != "mamba")
    ssd = sum(_ssd_flops_per_layer(cfg, shape.seq_len, B)
              for k in cfg.layer_kinds() if k == "mamba")
    if cfg.family == "encdec":
        attn += (cfg.encoder_layers *
                 2 * _attn_flops_per_layer(cfg, cfg.encoder_seq, cfg.encoder_seq, B)
                 + cfg.num_layers * _attn_flops_per_layer(
                     cfg, shape.seq_len, cfg.encoder_seq, B))
    fwd = matmul + attn + ssd
    if shape.kind == "train":
        useful = 3.0 * fwd
        # full per-layer remat recomputes the forward during backward
        total = (4.0 if remat else 3.0) * (fwd + moe_waste)
    else:
        useful = fwd
        total = fwd + moe_waste
    return {"total": float(total), "useful": float(useful),
            "matmul": float(matmul), "attn": float(attn + ssd),
            "tokens": float(tokens)}


# ---------------------------------------------------------------------------
# memory traffic & footprint
# ---------------------------------------------------------------------------

def kv_cache_bytes(cfg: ModelConfig, batch: int, seq: int) -> int:
    b = BYTES[cfg.dtype]
    total = 0
    for kind in cfg.layer_kinds():
        if kind == "mamba":
            d_in = cfg.d_inner
            H = d_in // cfg.ssm_head_dim
            total += batch * (H * cfg.ssm_head_dim * cfg.ssm_state_dim * 4
                              + (cfg.ssm_conv_width - 1) * (d_in + 2 * cfg.ssm_state_dim) * b)
        elif cfg.use_mla:
            total += batch * seq * (cfg.kv_lora_rank + cfg.rope_head_dim) * b
        else:
            eff = min(seq, cfg.sliding_window + 16) if cfg.sliding_window else seq
            total += 2 * batch * eff * cfg.num_kv_heads * cfg.head_dim * b
    if cfg.family == "encdec":
        total += 2 * cfg.num_layers * batch * cfg.encoder_seq * \
            cfg.num_kv_heads * cfg.head_dim * b
    return int(total)


def _unique_experts_touched(cfg: ModelConfig, n_tokens: int) -> float:
    """E[#unique experts activated by n_tokens] (uniform proxy)."""
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    return E * (1.0 - (1.0 - 1.0 / E) ** (n_tokens * k))


def weights_read_bytes(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """Weight bytes one replica must stream through HBM for one step.
    For MoE decode only the activated experts' weights are touched."""
    pb = BYTES[cfg.dtype]
    total_p, active_p = count_params(cfg)
    if not (cfg.is_moe and shape.kind == "decode"):
        return float(total_p * pb)
    uniq = _unique_experts_touched(cfg, shape.global_batch)
    per_expert = 3 * cfg.d_model * cfg.moe_d_ff
    routed_all = cfg.num_moe_layers * cfg.num_experts * per_expert
    routed_touched = cfg.num_moe_layers * uniq * per_expert
    return float((total_p - routed_all + routed_touched) * pb)


def step_hbm_bytes(cfg: ModelConfig, shape: ShapeConfig,
                   mesh_shape: Optional[Dict[str, int]] = None,
                   weight_gather: bool = False) -> float:
    """Global HBM traffic for one step, SHARDING-AWARE.

    Weights replicated over the data axis (serve default for small models)
    are read once per replica per step — the dominant decode cost.  With
    weight-gathered (ZeRO-style) serving the weights are read once globally
    (plus one extra pass for the gathered copy's write+read).
    """
    pb = BYTES[cfg.dtype]
    total_p, active_p = count_params(cfg)
    B = shape.global_batch
    dp = 1
    if mesh_shape:
        dp = mesh_shape.get("data", 1) * mesh_shape.get("pod", 1)
    if shape.kind == "decode":
        w = weights_read_bytes(cfg, shape)
        if weight_gather:
            w = w * 2.0          # read shards once + write/read gathered copy
        else:
            w = w * dp           # every data replica streams its own copy
        return float(w + kv_cache_bytes(cfg, B, shape.seq_len))
    tokens = B * shape.seq_len
    act = tokens * cfg.d_model * pb * cfg.num_layers  # remat-resident stream
    if shape.kind == "train":
        # fwd read + bwd read + grad write + opt update read/write (f32 m,v)
        return float(total_p * (pb * 3 + 4 * 4) + 2 * act)
    return float(total_p * pb + act)


# ---------------------------------------------------------------------------
# collective bytes (per step, summed over all devices' sends)
# ---------------------------------------------------------------------------

def collective_bytes(cfg: ModelConfig, shape: ShapeConfig, mesh_shape: Dict[str, int],
                     mode: str, weight_gather: bool = False) -> Dict[str, float]:
    """Closed-form collective-traffic model for the rule set in sharding.py.

    Returns global bytes moved per step per collective family.  Per-chip ICI
    time = total / (chips × link_bw) (the roofline's collective term).
    """
    pb = BYTES[cfg.dtype]
    model = mesh_shape.get("model", 1)
    dp = mesh_shape.get("data", 1) * mesh_shape.get("pod", 1)
    chips = model * dp
    total_p, _ = count_params(cfg)
    B, S = shape.global_batch, shape.seq_len
    tokens = B * (1 if shape.kind == "decode" else S)
    d = cfg.d_model
    out: Dict[str, float] = {"all_gather": 0.0, "reduce_scatter": 0.0,
                             "all_reduce": 0.0, "all_to_all": 0.0}
    # --- weight gathers (FSDP): each chip receives the other (dp-1)/dp of
    # its model-shard's weights, fwd (+bwd for train)
    fsdp_on = mode == "train" or weight_gather
    if fsdp_on and dp > 1:
        passes = 2 if shape.kind == "train" else 1
        out["all_gather"] += passes * chips * (total_p * pb / model) * (dp - 1) / dp
    # --- gradient reduce-scatter + opt-state all-gather equivalents (train)
    if shape.kind == "train" and dp > 1:
        out["reduce_scatter"] += chips * (total_p * pb / model) * (dp - 1) / dp
    # --- TP activation collectives: per attention/ffn block, the partial-sum
    # outputs are all-reduced over the model axis (2 per layer fwd)
    if model > 1:
        act_bytes = tokens * d * pb
        nlayers = cfg.num_layers + (cfg.encoder_layers or 0)
        passes = 4 if shape.kind == "train" else 2
        out["all_reduce"] += passes * nlayers * act_bytes * 2 * (model - 1) / model
        # EP all-to-all (deepseek-style E % model == 0): token dispatch+return
        if cfg.is_moe and cfg.num_experts % model == 0:
            k = cfg.num_experts_per_tok
            out["all_to_all"] += 2 * cfg.num_moe_layers * tokens * k * d * pb \
                * (model - 1) / model
    return out


def roofline_terms(cfg: ModelConfig, shape: ShapeConfig,
                   mesh_shape: Dict[str, int], mode: str,
                   weight_gather: bool = False,
                   remat: Optional[bool] = None,
                   capacity_factor: Optional[float] = None,
                   grad_compress: bool = False, verify_block: int = 1,
                   peak_flops: float = H100_BF16_FLOPS,
                   hbm_bw: float = H100_HBM_BW,
                   ici_bw: float = H100_NVLINK_BW) -> Dict[str, float]:
    """The three §Roofline terms (seconds) + bookkeeping."""
    chips = int(np.prod(list(mesh_shape.values())))
    fl = step_flops(cfg, shape, remat=remat, capacity_factor=capacity_factor)
    if verify_block > 1 and shape.kind == "decode":
        # SD verification: one step processes verify_block tokens, so the
        # per-step weight read amortizes over the block (flops/tokens scale,
        # hbm stays per-step)
        fl = {k: v * verify_block for k, v in fl.items()}
    hbm = step_hbm_bytes(cfg, shape, mesh_shape, weight_gather)
    coll = collective_bytes(cfg, shape, mesh_shape, mode, weight_gather)
    if grad_compress and shape.kind == "train":
        # int8+EF compression applies to the DP gradient reduce-scatter
        coll["reduce_scatter"] *= compressed_bytes_fraction() * 2  # vs bf16
    coll_total = sum(coll.values())
    t_comp = fl["total"] / (chips * peak_flops)
    t_mem = hbm / (chips * hbm_bw)
    t_coll = coll_total / (chips * ici_bw)
    total_p, active_p = count_params(cfg)
    model_flops = fl["useful"]
    dominant = max((("compute", t_comp), ("memory", t_mem),
                    ("collective", t_coll)), key=lambda kv: kv[1])[0]
    bound = max(t_comp, t_mem, t_coll)
    # roofline fraction = ideal time / achieved bound, where the ideal is the
    # hardware floor for this op: useful FLOPs at peak, but never below the
    # mandatory HBM traffic (weights once, plus the KV/SSM cache for decode).
    # = MFU when compute-bound; = bandwidth utilization when memory-bound.
    hbm_floor = weights_read_bytes(cfg, shape)
    if shape.kind == "decode":
        hbm_floor += kv_cache_bytes(cfg, shape.global_batch, shape.seq_len)
    ideal = max(model_flops / (chips * peak_flops),
                hbm_floor / (chips * hbm_bw))
    return {
        "t_compute": t_comp, "t_memory": t_mem, "t_collective": t_coll,
        "dominant": dominant,
        "flops": fl["total"], "hbm_bytes": hbm, "collective_bytes": coll_total,
        "collectives": coll,
        "model_flops": model_flops,
        "useful_ratio": model_flops / max(fl["total"], 1.0),
        "roofline_fraction": ideal / max(bound, 1e-30),
        "params_total": total_p, "params_active": active_p,
        "tokens": fl["tokens"],
    }
