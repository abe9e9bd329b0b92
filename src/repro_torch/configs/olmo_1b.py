"""OLMo-1B — dense, non-parametric LayerNorm.  [arXiv:2402.00838]"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="olmo-1b",
    family="dense",
    source="arXiv:2402.00838",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=8192,
    vocab_size=50_304,
    norm="nonparam_ln",
    tie_embeddings=True,
))
