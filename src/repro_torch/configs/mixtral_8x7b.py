"""mixtral-8x7b — 8-expert top-2 MoE with sliding-window attention.
[arXiv:2401.04088; hf].  Primary SP-MoE paper target."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    ffn_activation="swiglu",
    num_experts=8,
    num_experts_per_tok=2,
    moe_d_ff=14336,
    sliding_window=4096,       # SWA -> rolling KV cache -> long_500k eligible
)

# SP-MoE draft pairing (paper Table 1): Mistral-7B (dense, same dims, no MoE).
DRAFT_CONFIG = ModelConfig(
    name="mistral-7b-draft",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    ffn_activation="swiglu",
    sliding_window=4096,
)
