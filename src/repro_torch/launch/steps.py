"""Serving parameters of the LM path (port of the serve half of
``repro.launch.steps``: ``_cast_params``'s rule, applied per leaf as
``_cast_leaf``, and ``init_serve_params``).
The reference's mesh, sharding and train-step builders are not ported.
"""
from __future__ import annotations

import torch

from repro_torch.models import transformer as tfm
from repro_torch.weights import tree_map


def _cast_leaf(p, dt):
    """``dt`` for a large matmul leaf (>= 2 dims and >= 65,536 elements,
    stacked axes counted); small and 1-D leaves (norm scales, biases)
    stay float32."""
    if p.dtype == torch.float32 and p.ndim >= 2 and p.numel() >= 1 << 16:
        return p.to(dt)
    return p


def init_serve_params(cfg, seed=0, dtype: str = "bfloat16", *,
                      device="cuda"):
    """One client's model + the server model, random from ``seed`` (an
    int, or a ``torch.Generator`` whose device the draws are made on),
    on ``device``.  An int seeds a generator on ``device``, so a
    full-width init is drawn on the card.  Each weight is moved and cast
    as it is drawn, so the peak is the cast model plus one float32
    leaf (granite-3-8b in bf16: ~23 GB, where the whole float32 tree
    beside its bf16 copy was ~50 GB); the values are those of casting
    the whole float32 tree."""
    gen = seed if isinstance(seed, torch.Generator) else \
        torch.Generator(device=device).manual_seed(int(seed))
    dt = getattr(torch, dtype) if isinstance(dtype, str) else dtype

    def cast(t):
        return _cast_leaf(t.to(device), dt)
    params = {"client": tfm.init_client_params(cfg, gen, cast),
              "server": tfm.init_server_params(cfg, gen, cast)}
    return tree_map(cast, params)
