"""llama3.2-3b — small llama3, GQA kv=8, tied embeddings.
[hf:meta-llama/Llama-3.2-3B]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-3b",
    family="dense",
    num_layers=28,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=128256,
    ffn_activation="swiglu",
    rope_theta=500000.0,
    tie_embeddings=True,
)
