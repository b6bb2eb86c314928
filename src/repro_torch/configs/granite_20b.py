"""granite-20b — dense llama-arch code model, MQA (kv=1).  [arXiv:2405.04324; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b",
    family="dense",
    num_layers=52,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,            # MQA
    head_dim=128,
    d_ff=24576,
    vocab_size=49152,
    ffn_activation="gelu",   # 2-matrix MLP (GPTBigCode-style; 52L@6144 only sums to ~20B this way)
)
