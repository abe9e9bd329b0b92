"""Jamba-v0.1 52B — hybrid Mamba+attention 1:7 interleave, MoE 16e top-2.

[arXiv:2403.19887]  Attention every 8th layer (offset 4 in the block),
MoE every 2nd layer (offset 1).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    source="arXiv:2403.19887",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14_336,
    vocab_size=65_536,
    n_experts=16,
    experts_per_token=2,
    moe_d_ff=14_336,
    moe_layer_period=2,
    moe_layer_offset=1,
    attn_layer_period=8,
    attn_layer_offset=4,
    ssm_state=16,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_conv_kernel=4,
    norm="rms",
))
