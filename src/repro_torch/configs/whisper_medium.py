"""whisper-medium — enc-dec audio; conv frontend stubbed (frame embeddings).
[arXiv:2212.04356]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="encdec",
    num_layers=24,             # decoder blocks
    encoder_layers=24,
    encoder_seq=1500,          # precomputed frame embeddings from stub frontend
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,           # MHA
    head_dim=64,
    d_ff=4096,
    vocab_size=51865,
    ffn_activation="gelu",
    tie_embeddings=True,
)
