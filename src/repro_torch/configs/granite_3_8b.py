"""Granite-3 8B — dense GQA.  [hf:ibm-granite/granite-3.0-2b-base family]"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="granite-3-8b",
    family="dense",
    source="hf:ibm-granite/granite-3.0-8b-base",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=12_800,
    vocab_size=49_155,   # padded to 49,408 (padded_vocab)
    tie_embeddings=True,
    norm="rms",
))
