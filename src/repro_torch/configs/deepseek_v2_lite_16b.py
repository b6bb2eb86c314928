"""deepseek-v2-lite-16b — MoE with MLA (kv_lora=512), 64 routed top-6 + 2 shared.
[arXiv:2405.04434; hf]

One leading dense-FFN layer, then 26 MoE layers.  The two shared experts are
one swiglu FFN of width ``num_shared_experts * moe_d_ff`` (2816) added to the
routed sum.  Attention is multi-head latent attention: q/k heads of nope 128
+ rope 64, v heads of 128, a compressed KV latent of 512 per token and no q
compression.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,           # MLA: heads share the compressed latent cache
    head_dim=128,              # nope head dim
    d_ff=10944,                # dense FFN of the leading layer
    vocab_size=102400,
    ffn_activation="swiglu",
    num_experts=64,
    num_experts_per_tok=6,
    num_shared_experts=2,
    moe_d_ff=1408,
    first_dense_layers=1,
    use_mla=True,
    kv_lora_rank=512,
    q_lora_rank=0,             # v2-lite has no q compression
    rope_head_dim=64,
    v_head_dim=128,
)
