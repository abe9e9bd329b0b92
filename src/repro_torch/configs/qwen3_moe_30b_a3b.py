"""Qwen3-30B-A3B — MoE, 128 experts top-8.  [hf:Qwen/Qwen3-30B-A3B]"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    source="hf:Qwen/Qwen3-30B-A3B",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=768,           # assignment lists dense d_ff = moe granularity
    vocab_size=151_936,
    n_experts=128,
    experts_per_token=8,
    moe_d_ff=768,
    moe_layer_period=1,  # every layer MoE
    rope_theta=1_000_000.0,
    norm="rms",
))
