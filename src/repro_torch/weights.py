"""Carrying state between the reference package and the port, the fp32
policy both the tests and ``chip_smoke.py`` run under, and the device
policy of the trainers.

State trees on both sides are nested dicts/lists with the same keys, so
conversion is a tree map through numpy: the reference's parameters,
optimizer and bandit state come across as numpy arrays (``np.asarray``
on the JAX side) and go back the same way.
"""
from __future__ import annotations

import numpy as np
import torch


def tree_map(fn, tree, *rest):
    """Map ``fn`` over the leaves of nested dicts/lists/tuples.  Dicts
    are walked in sorted key order, as JAX walks its pytrees, so leaf
    order depends on the keys only, never on insertion order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree):
    """Leaves in :func:`tree_map` order."""
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [l for t in tree for l in tree_leaves(t)]
    return [tree]


def tree_unflatten(tree, leaves):
    """A tree of ``tree``'s structure holding ``leaves`` in leaf order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def tree_unstack(tree, n):
    """A tree of (n, ...) leaves as a list of its n row trees (views): one
    ``unbind`` per leaf, whose backward stacks the rows' gradients into
    one buffer, where indexing row by row would give each row's backward
    a zero-filled (n, ...) tensor."""
    rows = [torch.unbind(l) for l in tree_leaves(tree)]
    return [tree_unflatten(tree, [u[i] for u in rows]) for i in range(n)]


def _leaf_from_numpy(a, device):
    a = np.array(a, copy=True)
    if a.dtype.name == "bfloat16":
        # numpy's bf16 (ml_dtypes) has no torch counterpart: widen to
        # float32, which is exact, and narrow again on the torch side
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(a).to(device)


def from_numpy(tree, device):
    """Numpy (or array-like) leaves -> torch tensors on ``device``,
    keeping each leaf's dtype (float32 stays float32, int32 int32,
    bfloat16 bfloat16)."""
    return tree_map(lambda a: _leaf_from_numpy(a, device), tree)


def train_state_from_numpy(state, device, like=None):
    """The reference's ``launch.steps.init_train_state`` output (a tree of
    numpy arrays: the stacked client trees with their proj heads, the
    server, the per-segment mask list, and the Adam ``mu``, ``nu`` and
    scalar ``step``) as the port's LM train state on ``device``.  With
    ``like`` (a port train state, e.g. ``init_train_state``'s), every
    leaf must match its shape and dtype."""
    out = from_numpy(state, device)
    if like is not None:
        got = [(tuple(t.shape), t.dtype) for t in tree_leaves(out)]
        want = [(tuple(t.shape), t.dtype) for t in tree_leaves(like)]
        if got != want:
            bad = [i for i, (g, w) in enumerate(zip(got, want)) if g != w]
            raise ValueError(f"train state does not fit: {len(got)} leaves "
                             f"for {len(want)}, mismatched leaves {bad[:5]}")
    return out


def to_numpy(tree):
    """Torch tensor leaves -> numpy arrays on the host.  A bfloat16 leaf
    comes out as float32 (exact: numpy has no bfloat16 of its own)."""
    return tree_map(lambda t: t.detach().cpu().to(
        torch.float32 if t.dtype == torch.bfloat16 else t.dtype).numpy(),
        tree)


def to_host(tree):
    """CPU copies of a tree's CUDA tensor leaves (other leaves as they
    are): each copied without blocking into page-locked memory, then ONE
    stream sync for the whole tree."""
    leaves = tree_leaves(tree)
    cuda = [l for l in leaves if torch.is_tensor(l) and l.is_cuda]
    if not cuda:
        return tree
    out = []
    for l in leaves:
        if torch.is_tensor(l) and l.is_cuda:
            h = torch.empty(l.shape, dtype=l.dtype, pin_memory=True)
            h.copy_(l, non_blocking=True)
            l = h
        out.append(l)
    torch.cuda.current_stream(cuda[0].device).synchronize()
    return tree_unflatten(tree, out)


def strict_fp32():
    """Full-fp32 matrix products and convolutions on the card: no TF32
    (which keeps ~3 decimal digits) anywhere, so the port's numbers are
    comparable with the fp32 reference and with the kernels' own f32
    FMA accumulation."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def device_of(device) -> torch.device:
    """``torch.device(device)`` for a trainer.  Trainers run on the card
    unless the caller passes ``device="cpu"``; asking for a card that is
    missing raises rather than falling back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a trainer was asked for a CUDA card and none is "
                           "present; pass device='cpu' to run on the CPU")
    return device
