"""AdaSplit per-client server masks (§3.3, eq. 7-8), LeNet half (port of
``repro.core.masks``).

* ``per_scalar`` — one mask value per server parameter, applied by
  transforming the params before the forward (``apply_scalar_masks``),
  so grads are masked by the chain rule — exactly eq. 7.
* ``per_unit`` — one mask value per conv output channel / FC hidden
  unit, applied in activation space as gates.

Mask leaves are continuous, init 1.0, driven sparse by the L1 term;
``binarize`` thresholds them and ``sparsity`` reports the fraction of
zeros.  All trees are stacked with a leading client axis.
"""
from __future__ import annotations

import torch

from repro_torch.weights import tree_leaves, tree_map


def init_lenet_unit_masks(cfg, n_clients: int, device="cuda"):
    from repro_torch.models.lenet import split_index
    s = split_index(cfg)
    ones = lambda u: torch.ones((n_clients, u), device=device)
    return {"blocks": [ones(c) for c in cfg.conv_channels[s:]],
            "fc1": ones(120), "fc2": ones(cfg.d_model)}


def init_scalar_masks(server_params, n_clients: int):
    return tree_map(lambda p: torch.ones((n_clients,) + tuple(p.shape),
                                         dtype=p.dtype, device=p.device),
                    server_params)


def apply_scalar_masks(server_params, mask):
    """Effective server model M^s * m_i (eq. 7 via the chain rule); a
    stacked (S, ...) mask gives stacked effective weights."""
    return tree_map(lambda p, m: p * m.to(p.dtype), server_params, mask)


def gather_clients(tree, idx):
    """Every leaf (C, ...) -> (S, ...) rows ``idx``."""
    return tree_map(lambda l: l[idx], tree)


def scatter_clients(tree, idx, new):
    """Inverse of :func:`gather_clients`: a copy of ``tree`` with rows
    ``idx`` replaced by ``new``'s (S, ...) leaves."""
    return tree_map(lambda l, n: l.index_copy(0, idx, n.to(l.dtype)),
                    tree, new)


def binarize(masks, threshold: float = 0.05):
    return tree_map(lambda m: (m.abs() > threshold).to(m.dtype), masks)


def sparsity(masks, threshold: float = 0.05) -> float:
    leaves = tree_leaves(masks)
    zero = sum(float((m.abs() <= threshold).sum()) for m in leaves)
    tot = sum(m.numel() for m in leaves)
    return zero / max(tot, 1)
