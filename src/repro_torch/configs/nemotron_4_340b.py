"""nemotron-4-340b — dense, GQA kv=8, squared-ReLU FFN.  [arXiv:2402.16819]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b",
    family="dense",
    num_layers=96,
    d_model=18432,
    num_heads=96,
    num_kv_heads=8,
    head_dim=192,
    d_ff=73728,
    vocab_size=256000,
    ffn_activation="relu2",    # squared ReLU, 2-matrix FFN
)
