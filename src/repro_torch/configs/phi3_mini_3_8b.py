"""Phi-3-mini 3.8B — dense, RoPE SwiGLU GQA(kv=32 == MHA).  [arXiv:2404.14219]"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="phi3-mini-3.8b",
    family="dense",
    source="arXiv:2404.14219",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    head_dim=96,
    d_ff=8192,
    vocab_size=32_064,
    sliding_window=0,   # phi3 uses window 2047 in training; full here, as
                        # in the reference
    norm="rms",
))
