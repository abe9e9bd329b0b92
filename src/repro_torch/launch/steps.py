"""Serving parameters of the LM path (port of the serve half of
``repro.launch.steps``: ``_cast_params`` and ``init_serve_params``).
The reference's mesh, sharding and train-step builders are not ported.
"""
from __future__ import annotations

import torch

from repro_torch.models import transformer as tfm
from repro_torch.weights import tree_map


def _cast_params(tree, dtype):
    """``dtype`` params for large matmul leaves (>= 2 dims and >= 65,536
    elements, stacked axes counted); small and 1-D leaves (norm scales,
    biases) stay float32."""
    dt = getattr(torch, dtype) if isinstance(dtype, str) else dtype

    def one(p):
        if p.dtype == torch.float32 and p.ndim >= 2 and p.numel() >= 1 << 16:
            return p.to(dt)
        return p
    return tree_map(one, tree)


def init_serve_params(cfg, seed=0, dtype: str = "bfloat16", *,
                      device="cuda"):
    """One client's model + the server model, random from ``seed`` (an
    int, or a ``torch.Generator`` whose device the draws are made on),
    on ``device``.  An int seeds a generator on ``device``, so a
    full-width init is drawn on the card."""
    gen = seed if isinstance(seed, torch.Generator) else \
        torch.Generator(device=device).manual_seed(int(seed))
    params = {"client": tfm.init_client_params(cfg, gen),
              "server": tfm.init_server_params(cfg, gen)}
    return _cast_params(tree_map(lambda t: t.to(device), params), dtype)
