"""llava-next-mistral-7b — mistral-7b backbone + anyres patch-embedding stub.
[hf:llava-hf/llava-v1.6-mistral-7b-hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    ffn_activation="swiglu",
    num_patches=576,           # base-grid anyres tile, precomputed by stub frontend
)
