"""Qwen2-VL-72B — VLM backbone: M-RoPE, dynamic resolution.

[arXiv:2409.12191]  The vision encoder is a stub: precomputed patch
embeddings (``frontend_frames`` of them) enter through the client's
``frontend_proj`` and are spliced over the prompt's prefix.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    source="arXiv:2409.12191",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=29_568,
    vocab_size=152_064,
    qkv_bias=True,
    mrope_sections=(16, 24, 24),   # t/h/w sections of the half-dim (64)
    rope_theta=1_000_000.0,
    modality="vision_text",
    frontend_frames=1024,          # patch embeddings per sequence (stub)
    norm="rms",
))
