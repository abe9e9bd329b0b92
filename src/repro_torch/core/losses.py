"""Losses: supervised NT-Xent (AdaSplit eq. 5), cross-entropy, L1
(port of ``repro.core.losses``).

``ntxent_supervised`` is batched over any leading axes: ``(C, B, D)``
projections give ``(C,)`` per-client losses in one pass.  It is the
plain form of the loss and the tests' oracle; the trainer's client step
computes the same loss through the NT-Xent kernel
(``kernels.ntxent.ntxent_loss``).
"""
from __future__ import annotations

import torch

from repro_torch.weights import tree_leaves


def ntxent_supervised(q, labels, tau: float = 0.07, normalize: bool = True):
    """Supervised NT-Xent (eq. 5) over q (..., B, D), labels (..., B).

    Positives = same label, j != i; returns the mean over positive pairs
    per leading index.  The diagonal enters the logsumexp as -inf through
    ``masked_fill`` and never reaches the per-pair term, so no NaN can
    reach the gradient."""
    q = q.to(torch.float32)
    if normalize:
        q = q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + 1e-8)
    B = q.shape[-2]
    sim = torch.matmul(q, q.transpose(-1, -2)) / tau           # (..., B, B)
    eye = torch.eye(B, dtype=torch.bool, device=q.device)
    lse = torch.logsumexp(sim.masked_fill(eye, float("-inf")), dim=-1)
    pos = (labels[..., :, None] == labels[..., None, :]) & ~eye
    per_pair = lse[..., :, None] - sim                         # -log softmax
    n_pos = pos.sum(dim=(-2, -1)).clamp(min=1)
    total = torch.where(pos, per_pair, torch.zeros((), device=q.device))
    return total.sum(dim=(-2, -1)) / n_pos


def token_nll(logits, targets):
    """Per-example lse - gold logit, float32."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    return lse - gold


def cross_entropy(logits, targets):
    """Classification CE: logits (..., V), targets (...,) int; mean over
    every position."""
    return token_nll(logits, targets).mean()


def l1_penalty(tree):
    """Mean |.| over every element of every leaf (scale-free lambda)."""
    leaves = tree_leaves(tree)
    if not leaves:
        return torch.zeros((), dtype=torch.float32)
    total = sum(x.to(torch.float32).abs().sum() for x in leaves)
    n = sum(x.numel() for x in leaves)
    return total / n


def accuracy(logits, targets):
    """Mean top-1 hit rate over the last (batch) axis."""
    return (logits.argmax(dim=-1) == targets).to(torch.float32).mean(dim=-1)
