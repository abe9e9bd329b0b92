"""SeamlessM4T-large-v2 — encoder-decoder, multimodal (audio).

[arXiv:2308.11596]  The audio frontend (mel + conv) is a stub:
precomputed frame embeddings enter the encoder through the client's
``frontend_proj``.  24 encoder + 24 decoder layers.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    source="arXiv:2308.11596",
    n_layers=24,            # decoder layers
    n_encoder_layers=24,
    is_encoder_decoder=True,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    vocab_size=256_206,
    modality="audio",
    frontend_frames=1024,   # encoder frames per train example (stub)
    norm="ln",
))
