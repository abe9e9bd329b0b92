"""Mamba2-370m — attention-free SSD (state-space duality).  [arXiv:2405.21060]"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="mamba2-370m",
    family="ssm",
    source="arXiv:2405.21060",
    n_layers=48,
    d_model=1024,
    n_heads=0,          # attention-free
    n_kv_heads=0,
    head_dim=0,
    d_ff=0,             # mamba blocks only (no separate MLP)
    vocab_size=50_280,
    ssm_state=128,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_ngroups=1,
    ssm_conv_kernel=4,
    ssm_chunk=256,
    norm="rms",
    tie_embeddings=True,
))
