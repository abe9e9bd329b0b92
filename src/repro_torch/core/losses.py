"""Losses: supervised NT-Xent (AdaSplit eq. 5), cross-entropy, L1
(port of ``repro.core.losses``).

``ntxent_supervised`` is batched over any leading axes: ``(C, B, D)``
projections give ``(C,)`` per-client losses in one pass.  It is the
plain form of the loss and the tests' oracle; the trainer's client step
computes the same loss through the NT-Xent kernel
(``kernels.ntxent.ntxent_loss``).  ``chunked_cross_entropy`` is the LM
trainer's token CE.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

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


def _chunk_nll(h, y, w, table, pad_bias):
    """Weighted sum of one chunk's token NLL: h (B, c, D), y and w (B, c)."""
    logits = torch.einsum("bsd,vd->bsv", h.to(torch.float32),
                          table.to(torch.float32)) + pad_bias
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, y[..., None].long())[..., 0]
    return ((lse - gold) * w.to(torch.float32)).sum()


def chunked_cross_entropy(hidden, table, labels, vocab_size: int,
                          chunk: int = 512, weights=None):
    """Token CE without materialising (B, S, Vpad) logits.

    hidden: (B, S, D) final hidden states; table: (Vpad, D) lm_head;
    labels: (B, S) int; weights: optional (B, S) per-token weights
    (AdaSplit cohort selection).  Runs over sequence chunks (halved
    until one divides S); each chunk's logits are recomputed in the
    backward pass (``torch.utils.checkpoint``, as the reference's
    ``jax.checkpoint``), so the peak is one (B, chunk, Vpad) float32
    block.  Padded vocab rows leave the logsumexp through a -1e9 bias.
    Returns sum(nll * w) / max(sum(w), 1e-8)."""
    B, S, D = hidden.shape
    Vp = table.shape[0]
    chunk = min(chunk, S)
    while S % chunk:
        chunk //= 2
    dev = hidden.device
    pad_bias = torch.where(torch.arange(Vp, device=dev) < vocab_size,
                           0.0, -1e9).to(torch.float32)
    if weights is None:
        weights = torch.ones((B, S), dtype=torch.float32, device=dev)
    total = None
    for c0 in range(0, S, chunk):
        part = checkpoint(_chunk_nll, hidden[:, c0:c0 + chunk],
                          labels[:, c0:c0 + chunk], weights[:, c0:c0 + chunk],
                          table, pad_bias, use_reentrant=False)
        total = part if total is None else total + part
    return total / torch.clamp(weights.to(torch.float32).sum(), min=1e-8)


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
