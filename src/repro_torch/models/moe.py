"""Mixture-of-Experts block: top-k router + capacity-bounded scatter
dispatch + stacked-expert SwiGLU + shared experts (DeepSeek style).
Port of ``repro.models.moe``.

Dispatch is group-wise (one group per batch row) and sort-free: every
(token, slot) assignment takes its position inside its expert's
capacity buffer from an exclusive one-hot cumsum *within its row*.  An
assignment is kept only below the row's capacity ``C``; the kept rows
are scattered into an ``(E, B, C, D)`` buffer, the three expert
products run as ``torch.bmm`` over E on ``(E, B*C, D)``, and the
outputs are gathered back.  Every shape is static and nothing is read
on the host, so a decode step holds no host sync.

The router aux loss (Switch-style load balance) is returned to the
caller.  The reference's ``ep_pins`` (expert-parallel sharding pins)
are not ported: the port runs on one card.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.layers import _normal, dense_init
from repro_torch.models.mlp import mlp_forward


# dropped and total (token, slot) assignments of every ``moe_forward``
# call while counting is on: the dropped count is a device tensor, read
# once after a run (``drop_share``), never inside a step
DROPS = {"on": False, "dropped": 0, "assigned": 0}


def count_drops(on: bool = True):
    """Start (or stop) counting dropped assignments, from zero."""
    DROPS.update(on=on, dropped=0, assigned=0)


def drop_share() -> float:
    """Share of the assignments counted since ``count_drops`` that their
    expert's capacity dropped (one host read)."""
    return float(DROPS["dropped"]) / max(DROPS["assigned"], 1)


def _expert_init(gen, lead, shape, scale, cast):
    """A stacked expert leaf ``lead + shape``, N(0, scale**2), drawn one
    row of ``lead`` at a time (in that order whether or not ``cast`` is
    given, so the values never depend on it).  ``cast(row, full_shape)``
    is applied to each row as it is drawn: a serving init then holds the
    cast stack and one float32 row, never the whole float32 leaf."""
    full = tuple(lead) + tuple(shape)
    out = None
    for r in range(math.prod(lead)):
        w = _normal(gen, shape).mul_(scale)
        if cast is not None:
            w = cast(w, full)
        if out is None:
            out = torch.empty(full, dtype=w.dtype, device=w.device)
        out.view((-1,) + tuple(shape))[r] = w
    return out


def moe_init(gen, cfg, lead=(), cast=None):
    """Router, stacked experts (E, D, F) / (E, F, D) and, where
    ``n_shared_experts``, the shared experts' SwiGLU, each with the
    ``lead`` axes in front."""
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    p = {
        "router": dense_init(gen, d, e, scale=0.02, lead=lead, cast=cast),
        "w_gate": _expert_init(gen, lead, (e, d, f), 1 / math.sqrt(d), cast),
        "w_up": _expert_init(gen, lead, (e, d, f), 1 / math.sqrt(d), cast),
        "w_down": _expert_init(gen, lead, (e, f, d), 1 / math.sqrt(f), cast),
    }
    if cfg.n_shared_experts:
        fs = cfg.moe_d_ff * cfg.n_shared_experts
        p["shared"] = {
            "w_gate": dense_init(gen, d, fs, lead=lead, cast=cast),
            "w_up": dense_init(gen, d, fs, lead=lead, cast=cast),
            "w_down": dense_init(gen, fs, d, lead=lead, cast=cast),
        }
    return p


def _capacity(tokens_per_group: int, cfg) -> int:
    cap = int(tokens_per_group * cfg.experts_per_token / cfg.n_experts
              * cfg.moe_capacity_factor)
    return max(8, ((cap + 7) // 8) * 8)


def top_k_lower_index(probs, k: int):
    """The ``k`` largest values along the last axis and their indices,
    ties broken toward the LOWER index, as ``jax.lax.top_k`` breaks them
    (``torch.topk`` makes no promise on ties): a stable descending
    sort."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(p, x, cfg):
    """Router of ``x`` (B, S, D): the renormalised top-K gate values and
    expert indices (B, S, K), the f32 softmax probabilities (B, S, E) and
    the Switch aux loss (top-1 density x mean prob x E)."""
    E, K = cfg.n_experts, cfg.experts_per_token
    logits = (x @ p["router"].to(x.dtype)).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, idx = top_k_lower_index(probs, K)
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)
    experts = torch.arange(E, device=x.device)
    density = (idx[..., 0, None] == experts).to(torch.float32).mean((0, 1))
    aux = torch.sum(density * probs.mean((0, 1))) * E
    return gate_vals, idx, probs, aux


def dispatch(idx, C: int, E: int):
    """Capacity positions of the (B, S*K) assignments, in ``s*K + k``
    order, from an exclusive one-hot cumsum per row.  Returns the
    expert and slot each assignment writes (dropped ones aim at
    ``(0, C-1)``) and the keep mask (position < C)."""
    B = idx.shape[0]
    flat_e = idx.reshape(B, -1)                                   # (B, SK)
    onehot = (flat_e[..., None] == torch.arange(E, device=idx.device)
              ).to(torch.int32)                                   # (B,SK,E)
    pos_in_e = torch.cumsum(onehot, dim=1, dtype=torch.int32) - onehot
    pos = torch.gather(pos_in_e, 2, flat_e[..., None])[..., 0]
    keep = pos < C
    e_idx = torch.where(keep, flat_e, 0)
    c_idx = torch.where(keep, pos, C - 1)
    return e_idx, c_idx, keep


def moe_forward(p, x, cfg, expert_gate: Optional[torch.Tensor] = None):
    """x: (B, S, D) -> (out, aux_loss f32).

    expert_gate: optional (E,) mask — AdaSplit's structured server mask
    at expert granularity, on each routed expert's output — or (B, E),
    per example (each example gated by its client's expert mask)."""
    dtype = x.dtype
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.experts_per_token
    C = _capacity(S, cfg)

    gate_vals, idx, _, aux = route(p, x, cfg)
    e_idx, c_idx, keep = dispatch(idx, C, E)
    if DROPS["on"]:
        DROPS["dropped"] = DROPS["dropped"] + (~keep).sum()
        DROPS["assigned"] += keep.numel()

    # scatter the kept (token, slot) rows into the (E, B, C, D) buffer;
    # each slot gets at most one kept row, a dropped row adds zeros at
    # (0, C-1): the reference's ``.at[].add``
    rows = torch.arange(B, device=x.device)[:, None] * C
    lin = (e_idx * (B * C) + rows + c_idx).reshape(-1)            # (B*SK,)
    src = x.reshape(B, S, 1, D).expand(B, S, K, D).reshape(B, S * K, D)
    src = torch.where(keep[..., None], src, torch.zeros((), dtype=dtype,
                                                        device=x.device))
    buf = torch.zeros((E * B * C, D), dtype=dtype, device=x.device)
    buf.index_add_(0, lin, src.reshape(-1, D))

    # the expert SwiGLU, three batched products over E
    buf = buf.view(E, B * C, D)
    h = F.silu(torch.bmm(buf, p["w_gate"].to(dtype))) \
        * torch.bmm(buf, p["w_up"].to(dtype))
    out = torch.bmm(h, p["w_down"].to(dtype)).view(E, B, C, D)
    if expert_gate is not None:
        g = expert_gate.to(dtype)
        g = g[:, None, None, None] if g.ndim == 1 else g.T[:, :, None, None]
        out = out * g

    # gather back to tokens, zero where dropped, weight and sum over K
    tok_out = out.reshape(E * B * C, D).index_select(0, lin)
    tok_out = torch.where(keep.reshape(-1, 1), tok_out,
                          torch.zeros((), dtype=dtype, device=x.device))
    w = gate_vals.reshape(-1, 1).to(dtype)
    y = (tok_out * w).reshape(B, S, K, D).sum(dim=2)

    if cfg.n_shared_experts:
        y = y + mlp_forward(p["shared"], x)
    return y, aux.to(torch.float32)
