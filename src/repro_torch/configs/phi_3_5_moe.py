"""phi-3.5-moe — the SP-MoE paper's second target (16 experts, top-2), and
its draft phi-mini-moe, itself an MoE (16 experts, top-2, expert width
960).  [arXiv:2412.08905; hf:microsoft/Phi-3.5-MoE-instruct,
hf:microsoft/Phi-mini-MoE-instruct]

The port's copy of the reference's ``configs/phi_3_5_moe.py`` as it stands,
field for field.  The norm, rotary embedding and projections are the ones
every config of the repository uses (RMSNorm, plain RoPE, no biases), not
the hub checkpoints' own: the widths, heads, vocabulary and routing are the
published ones.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi-3.5-moe",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=6400,
    vocab_size=32064,
    ffn_activation="swiglu",
    num_experts=16,
    num_experts_per_tok=2,
    moe_d_ff=6400,
)

# SP-MoE draft pairing (paper Table 1): Phi-mini-MoE, an MoE of the same
# depth, width and heads with narrow experts.
DRAFT_CONFIG = ModelConfig(
    name="phi-mini-moe-draft",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=960,
    vocab_size=32064,
    ffn_activation="swiglu",
    num_experts=16,
    num_experts_per_tok=2,
    moe_d_ff=960,
)
