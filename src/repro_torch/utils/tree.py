"""Small tree helpers (port of ``repro.utils.tree``), on the port's
nested dict/list trees of tensors (``weights.tree_map`` order), and the
two the port's trainers take gradients with (``tree_requires_grad``,
``tree_grads``: JAX's ``value_and_grad`` over a tree argument).

The reference's ``split_keys`` splits a JAX PRNG key and has no caller;
the port draws its randomness from explicit ``torch.Generator``s."""
from __future__ import annotations

import torch

from repro_torch.weights import tree_leaves, tree_map, tree_unflatten


def tree_add(a, b, scale_b: float = 1.0):
    return tree_map(lambda x, y: x + scale_b * y, a, b)


def tree_sub(a, b):
    return tree_map(lambda x, y: x - y, a, b)


def tree_scale(a, s):
    return tree_map(lambda x: x * s, a)


def tree_zeros_like(a):
    return tree_map(torch.zeros_like, a)


def tree_l2_norm(a):
    sq = [(x.to(torch.float32) ** 2).sum() for x in tree_leaves(a)]
    return torch.sqrt(sum(sq)) if sq else torch.tensor(0.0)


def tree_size(a) -> int:
    return sum(x.numel() for x in tree_leaves(a))


def tree_bytes(a) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(a))


def tree_cast(a, dtype):
    return tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x,
                    a)


def tree_requires_grad(tree):
    """Leaves detached from any graph and requiring a gradient."""
    return tree_map(lambda t: t.detach().requires_grad_(True), tree)


def tree_grads(loss, tree):
    """d loss / d every leaf of ``tree`` (a tuple of trees gives a tuple
    of gradient trees), in ``tree``'s structure."""
    return tree_unflatten(tree, torch.autograd.grad(loss, tree_leaves(tree)))
