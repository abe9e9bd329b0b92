"""SwiGLU MLP (gate/up/down), port of ``repro.models.mlp``."""
from __future__ import annotations

import torch.nn.functional as F

from repro_torch.models.layers import dense_init


def mlp_init(gen, d_model, d_ff, lead=(), cast=None):
    return {
        "w_gate": dense_init(gen, d_model, d_ff, lead=lead, cast=cast),
        "w_up": dense_init(gen, d_model, d_ff, lead=lead, cast=cast),
        "w_down": dense_init(gen, d_ff, d_model, lead=lead, cast=cast),
    }


def mlp_forward(p, x, unit_gate=None):
    """unit_gate: optional (d_ff,) or broadcastable mask on the hidden
    units — AdaSplit's structured per-client server mask applied in
    activation space (row-mask of w_down)."""
    dtype = x.dtype
    h = F.silu(x @ p["w_gate"].to(dtype)) * (x @ p["w_up"].to(dtype))
    if unit_gate is not None:
        h = h * unit_gate.to(dtype)
    return h @ p["w_down"].to(dtype)
