"""Adam optimizer on trees of tensors (port of ``repro.optim.adam``).

Moments are float32 whatever the parameter dtype.  ``state["step"]`` is
a scalar, or an ``(S,)`` vector of per-row steps for trees of stacked
``(S, ...)`` leaves — the per-client step vectors of the trainer's
client and mask optimizers, which the reference applies under ``vmap``.
"""
from __future__ import annotations

import torch

from repro_torch.weights import tree_leaves, tree_map, tree_unflatten


def adam_init(params):
    f32 = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                device=p.device)
    dev = tree_leaves(params)[0].device
    return {"mu": tree_map(f32, params), "nu": tree_map(f32, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def adam_update(params, grads, state, *, lr, b1=0.9, b2=0.999, eps=1e-8):
    """Returns (new_params, new_state); no autograd through the update."""
    step = state["step"] + 1
    stepf = step.to(torch.float32)
    b1t = 1.0 - torch.pow(b1, stepf)
    b2t = 1.0 - torch.pow(b2, stepf)

    def rows(c, p):
        return c.reshape(c.shape + (1,) * (p.ndim - c.ndim))

    def upd(p, g, mu, nu):
        g = g.to(torch.float32)
        mu = b1 * mu + (1 - b1) * g
        nu = b2 * nu + (1 - b2) * g * g
        mhat = mu / rows(b1t, mu)
        nhat = nu / rows(b2t, nu)
        delta = mhat / (torch.sqrt(nhat) + eps)
        return (p.to(torch.float32) - lr * delta).to(p.dtype), mu, nu

    with torch.no_grad():
        out = [upd(p, g, m, n) for p, g, m, n in zip(
            tree_leaves(params), tree_leaves(grads), tree_leaves(state["mu"]),
            tree_leaves(state["nu"]))]
    new = [tree_unflatten(params, [o[i] for o in out]) for i in range(3)]
    return new[0], {"mu": new[1], "nu": new[2], "step": step}
