"""Adam optimizer on trees of tensors (port of ``repro.optim.adam``).

Moments are float32 whatever the parameter dtype.  ``state["step"]`` is
a scalar, or an ``(S,)`` vector of per-row steps for trees of stacked
``(S, ...)`` leaves — the per-client step vectors of the trainer's
client and mask optimizers, which the reference applies under ``vmap``.
On CUDA tensors the whole update is one launch of the multi-tensor Adam
kernel (``kernels/masked_adam.py``, in this module's rounding order);
on CPU tensors each leaf runs ``adam_leaf_plain``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.masked_adam import adam_multi, bias_corrections
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
    b1t, b2t = bias_corrections(step, b1, b2)
    with torch.no_grad():
        out = adam_multi([(p, g, m, n, None) for p, g, m, n in zip(
            tree_leaves(params), tree_leaves(grads), tree_leaves(state["mu"]),
            tree_leaves(state["nu"]))], lr=lr, b1=b1, b2=b2, eps=eps,
            b1t=b1t, b2t=b2t, client_order=True)
    new = [tree_unflatten(params, [o[i] for o in out]) for i in range(3)]
    return new[0], {"mu": new[1], "nu": new[2], "step": step}
