"""zamba2-7b — hybrid Mamba2 + shared attention blocks.  [arXiv:2411.15242]

Simplification (kept from the reference): Zamba2 interleaves a
*shared-weight* transformer block (with per-site LoRA deltas) every ~6
Mamba2 blocks; the cadence is modelled with one shared attention block every
``attn_every`` layers, with no LoRA deltas.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,           # shared attn block is MHA
    head_dim=112,
    d_ff=14336,
    vocab_size=32000,
    ffn_activation="swiglu",
    ssm_state_dim=64,
    ssm_expand=2,
    ssm_head_dim=64,
    attn_every=6,
)
