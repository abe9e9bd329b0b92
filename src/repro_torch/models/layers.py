"""Shared layer primitives of the LM stack: norms, RoPE and M-RoPE,
embeddings, projection init (port of ``repro.models.layers``).

Layers are functions over nested dicts of tensors; initialisers draw
from an explicit ``torch.Generator`` and create on ``gen.device``.
Compute dtype is the caller's: params are cast at the call site.
"""
from __future__ import annotations

import math

import torch


def _normal(gen, shape):
    return torch.randn(shape, generator=gen, device=gen.device,
                       dtype=torch.float32)


def dense_init(gen, d_in, d_out, scale=None, lead=(), cast=None):
    """(*lead, d_in, d_out) float32 weights, N(0, 1/d_in) by default;
    ``lead`` stacks independent draws (the segments' n_rep axis);
    ``cast``, where given, is applied to the draw at once (a serving
    init keeps only the cast copy of each weight, never the whole
    float32 model beside it)."""
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = _normal(gen, tuple(lead) + (d_in, d_out)).mul_(scale)
    return w if cast is None else cast(w)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def norm_init(d, kind: str, lead=(), device="cuda"):
    if kind == "rms":
        return {"scale": torch.ones(tuple(lead) + (d,), device=device)}
    if kind == "ln":
        return {"scale": torch.ones(tuple(lead) + (d,), device=device),
                "bias": torch.zeros(tuple(lead) + (d,), device=device)}
    if kind == "nonparam_ln":
        return {}
    raise ValueError(kind)


def apply_norm(params, x, kind: str, eps: float = 1e-6):
    """float32 inside, cast back to x's dtype."""
    xf = x.to(torch.float32)
    if kind == "rms":
        y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
        y = y * params["scale"]
    else:  # ln / nonparam_ln
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        if kind == "ln":
            y = y * params["scale"] + params["bias"]
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE / M-RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device="cpu"):
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, hd); positions: broadcastable to (..., S).  The
    split-halves form: (x1, x2) -> (x1 cos - x2 sin, x1 sin + x2 cos)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)
    return _rotate(x, positions[..., None].to(torch.float32) * freqs)


def _rotate(x, ang):
    """Rotate x (..., S, H, hd) by the angles ang (..., S, hd/2), shared
    by every head."""
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x, positions3, theta: float, sections):
    """Multimodal RoPE (Qwen2-VL).  x: (..., S, H, hd); positions3:
    (..., S, 3), the (t, h, w) position ids.  ``sections`` partition the
    half-dim: the frequencies of section s rotate with stream s."""
    hd = x.shape[-1]
    half = hd // 2
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {tuple(sections)} do not sum to "
                         f"the half-dim {half}")
    freqs = rope_freqs(hd, theta, device=x.device)
    # each section's stream repeated over its frequencies, by views and
    # one cat: an index tensor built from ``sections`` would be a
    # host-to-device copy (and a sync) at every call
    p = positions3.to(torch.float32)
    pos = torch.cat([p[..., i:i + 1].expand(p.shape[:-1] + (n,))
                     for i, n in enumerate(sections)], dim=-1)
    return _rotate(x, pos * freqs)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------


def embedding_init(gen, vocab_padded, d_model, cast=None):
    w = _normal(gen, (vocab_padded, d_model)).mul_(0.02)
    return {"table": w if cast is None else cast(w)}


def embed(params, tokens, dtype):
    """Rows of the table, cast to ``dtype`` (gathered first: the same
    values as casting the whole table)."""
    return params["table"][tokens].to(dtype)


def unembed(params, x, tied_table=None):
    """x: (..., D) -> float32 logits (..., Vpad)."""
    table = tied_table if tied_table is not None else params["table"]
    return x.to(torch.float32) @ table.to(torch.float32).T


def vocab_pad_bias(vocab_size: int, vocab_padded: int, device="cpu"):
    """Additive logit bias masking padded vocab rows."""
    bias = torch.zeros((vocab_padded,), dtype=torch.float32, device=device)
    bias[vocab_size:] = -1e9
    return bias
