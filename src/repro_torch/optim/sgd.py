"""SGD (+momentum) (port of ``repro.optim.sgd``): the local optimizer
that the FL baselines' derivations assume (Scaffold, FedNova)."""
from __future__ import annotations

import torch

from repro_torch.weights import tree_map


def sgd_init(params, momentum: float = 0.0):
    if momentum:
        return {"m": tree_map(lambda p: torch.zeros(
            p.shape, dtype=torch.float32, device=p.device), params)}
    return {}


def sgd_update(params, grads, state, *, lr, momentum: float = 0.0,
               mask=None):
    """Returns (new_params, new_state); ``mask`` an optional tree of
    multiplicative gradient masks."""
    if mask is not None:
        grads = tree_map(lambda g, m: g * m.to(g.dtype), grads, mask)
    if momentum:
        new_m = tree_map(lambda m, g: momentum * m + g.to(torch.float32),
                         state["m"], grads)
        new_p = tree_map(
            lambda p, m: (p.to(torch.float32) - lr * m).to(p.dtype),
            params, new_m)
        return new_p, {"m": new_m}
    new_p = tree_map(
        lambda p, g: (p.to(torch.float32)
                      - lr * g.to(torch.float32)).to(p.dtype),
        params, grads)
    return new_p, state
