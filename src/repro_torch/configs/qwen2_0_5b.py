"""Qwen2-0.5B — dense GQA with QKV bias.  [arXiv:2407.10671]"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen2-0.5b",
    family="dense",
    source="arXiv:2407.10671",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab_size=151_936,
    qkv_bias=True,
    tie_embeddings=True,
    rope_theta=1_000_000.0,
    norm="rms",
))
