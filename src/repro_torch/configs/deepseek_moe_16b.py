"""DeepSeekMoE-16B — 2 shared + 64 routed top-6, fine-grained; first layer
dense.  [arXiv:2401.06066]"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    source="arXiv:2401.06066",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=10_944,         # dense FFN width of the first layer
    vocab_size=102_400,
    n_experts=64,
    n_shared_experts=2,
    experts_per_token=6,
    moe_d_ff=1408,
    moe_layer_period=1,
    first_k_dense=1,
    norm="rms",
))
