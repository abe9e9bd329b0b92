"""Decoder-only LM stack, dense and MoE (port of
``repro.models.transformer``).

The stack is organised into **segments**: maximal runs of layers whose
(mixer, ffn) pattern repeats with period P.  Segment params are
stacked with a leading ``n_rep`` axis as in the reference, and the
reference's scan over ``n_rep`` is a Python loop here.  AdaSplit's
client/server split slices the stack at ``cfg.split_layer`` and
re-segments each side.

This slice carries the ``attn`` mixer and the ``dense`` and ``moe``
ffns; the SSM, cross-attention and modality-frontend branches raise
``NotImplementedError`` naming the slice that brings them.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import (apply_norm, embed, embedding_init,
                                       norm_init, unembed, vocab_pad_bias)
from repro_torch.weights import tree_unstack

_LATER = {"ssm": "the SSM/hybrid slice (models/ssm.py)",
          "cross": "the encoder-decoder slice",
          "frontend": "the multimodal (audio / vision) slice"}


def _later(what: str):
    raise NotImplementedError(f"{what} is not ported yet: it comes with "
                              f"{_LATER[what]}")


def refuse_moe_training(cfg: ModelConfig):
    """Training an MoE stack needs the router aux loss in the objective
    (the reference adds ``router_aux_coef * aux``), which the port's
    train step does not compute: refuse rather than train without it."""
    if cfg.n_experts:
        raise NotImplementedError(
            f"{cfg.name}: MoE training is not ported yet (ROADMAP.md, "
            "queue 1: \"MoE training (router aux loss)\"); the port "
            "serves MoE configs only")


# ---------------------------------------------------------------------------
# Segment plan
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class LayerDesc:
    mixer: str          # "attn" | "ssm"
    ffn: str            # "dense" | "moe" | "none"
    cross: bool = False
    causal: bool = True


@dataclass(frozen=True)
class Segment:
    n_rep: int
    body: Tuple[LayerDesc, ...]


def _desc(cfg: ModelConfig, i: int) -> LayerDesc:
    mixer = "attn" if (cfg.n_heads and cfg.is_attn_layer(i)) else "ssm"
    if cfg.is_moe_layer(i):
        ffn = "moe"
    elif cfg.d_ff:
        ffn = "dense"
    else:
        ffn = "none"
    return LayerDesc(mixer, ffn)


def build_segments(cfg: ModelConfig, start: int, end: int) -> List[Segment]:
    """Segment plan for layers [start, end)."""
    if start >= end:
        return []
    segs: List[Segment] = []
    i = start
    while i < min(end, cfg.first_k_dense):
        segs.append(Segment(1, (_desc(cfg, i),)))
        i += 1
    P = 1
    for p in (cfg.attn_layer_period, cfg.moe_layer_period):
        if p and p > 1:
            P = P * p // math.gcd(P, p)
    n = end - i
    if n <= 0:
        return segs
    n_rep, tail = divmod(n, P)
    if n_rep:
        segs.append(Segment(n_rep, tuple(_desc(cfg, i + k)
                                         for k in range(P))))
        i += n_rep * P
    for k in range(tail):
        segs.append(Segment(1, (_desc(cfg, i + k),)))
    return segs


# ---------------------------------------------------------------------------
# Param init
# ---------------------------------------------------------------------------


def _check_layer(desc: LayerDesc):
    if desc.mixer != "attn":
        _later("ssm")
    if desc.cross:
        _later("cross")


def _layer_init(gen, cfg: ModelConfig, desc: LayerDesc, n_rep: int,
                cast=None):
    """One body position's params, stacked over ``n_rep``; ``cast``, where
    given, applied to each weight as it is drawn."""
    _check_layer(desc)
    lead = (n_rep,)
    p: Dict[str, Any] = {"norm1": norm_init(cfg.d_model, cfg.norm, lead,
                                            gen.device),
                         "mixer": attn.attention_init(gen, cfg, lead, cast)}
    if desc.ffn != "none":
        p["norm2"] = norm_init(cfg.d_model, cfg.norm, lead, gen.device)
        p["ffn"] = moe_mod.moe_init(gen, cfg, lead, cast) \
            if desc.ffn == "moe" else \
            mlp_mod.mlp_init(gen, cfg.d_model, cfg.d_ff, lead, cast)
    return p


def segment_init(gen, cfg: ModelConfig, seg: Segment, cast=None):
    """Params of one segment: a list over the body, leaves (n_rep, ...)."""
    return [_layer_init(gen, cfg, d, seg.n_rep, cast) for d in seg.body]


# ---------------------------------------------------------------------------
# Layer apply
# ---------------------------------------------------------------------------


def _gate_or_none(gates, name):
    if gates is None:
        return None
    return gates.get(name)


def _unit_gate(gate, dtype):
    """(U,) for one client, or (B, U) per example -> broadcast over S."""
    if gate is None:
        return None
    g = gate.to(dtype)
    return g if g.ndim == 1 else g[:, None, :]


def _ffn(cfg: ModelConfig, p, desc: LayerDesc, x, gates):
    """The ffn sublayer and its residual add: the dense SwiGLU, its
    hidden units gated, or the MoE block, its experts gated (an (E,) or
    (B, E) gate as it comes)."""
    if desc.ffn == "none":
        return x
    h = apply_norm(p["norm2"], x, cfg.norm)
    gate = _gate_or_none(gates, "ffn")
    if desc.ffn == "moe":
        return x + moe_mod.moe_forward(p["ffn"], h, cfg, expert_gate=gate)[0]
    return x + mlp_mod.mlp_forward(p["ffn"], h,
                                   unit_gate=_unit_gate(gate, x.dtype))


def apply_layer(cfg: ModelConfig, p, desc: LayerDesc, x, *, positions=None,
                window=0, gates=None, kv_len=None, training=False):
    """Full-sequence layer.  Returns (x, (k, v)): the layer's K/V, which
    prefill stashes as its cache.  (The reference returns the MoE
    router's aux loss in its place; ``moe_forward`` computes it, and no
    serving path reads it.)  ``training`` takes the differentiable
    training attention in place of the flash kernel
    (``attn.attn_forward``)."""
    _check_layer(desc)
    h = apply_norm(p["norm1"], x, cfg.norm)
    out, kv = attn.attn_forward(p["mixer"], h, cfg, positions=positions,
                                causal=desc.causal, window=window,
                                head_gate=_gate_or_none(gates, "mixer"),
                                kv_len=kv_len, training=training)
    x = x + out
    return _ffn(cfg, p, desc, x, gates), kv


def apply_layer_decode(cfg: ModelConfig, p, desc: LayerDesc, x, cache, pos,
                       *, window=0, gates=None):
    """One-token layer step.  Returns (x, new_cache)."""
    _check_layer(desc)
    h = apply_norm(p["norm1"], x, cfg.norm)
    new_cache = dict(cache)
    out, kv = attn.attn_decode(p["mixer"], h, cache["mixer"], pos, cfg,
                               window=window,
                               head_gate=_gate_or_none(gates, "mixer"))
    new_cache["mixer"] = kv
    x = x + out
    return _ffn(cfg, p, desc, x, gates), new_cache


# ---------------------------------------------------------------------------
# Segment runners (a loop over n_rep)
# ---------------------------------------------------------------------------


def _rep(tree, r):
    """Row ``r`` of every leaf of a stacked (n_rep, ...) tree."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _rep(v, r) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rep(v, r) for v in tree)
    return tree[r]


def _body_gates(gates, j):
    if gates is None:
        return None
    return gates.get(str(j))


def run_segments(cfg, segments, seg_params, x, *, positions=None, window=0,
                 gates=None, kv_len=None, on_layer=None, training=False,
                 remat=False):
    """gates: optional list aligned with segments; each entry a tree with
    leading n_rep dims matching the segment params (see core/masks.py).
    on_layer(si, j, (k, v)): optional hook called with every layer's
    K/V, in order (prefill stashes its cache through it).
    training: every layer on the differentiable training attention.
    remat: each layer under ``torch.utils.checkpoint`` (its activations
    recomputed in the backward pass, the reference's ``jax.checkpoint``
    of each scan step); no ``on_layer`` hook with it.  Returns x."""
    if remat and on_layer is not None:
        raise ValueError("remat keeps no layer's K/V for on_layer")
    if training or remat:
        refuse_moe_training(cfg)
    for si, (seg, sp) in enumerate(zip(segments, seg_params)):
        g_seg = gates[si] if gates is not None else None
        g_reps = [None] * seg.n_rep if g_seg is None else \
            tree_unstack(g_seg, seg.n_rep)
        p_reps = [tree_unstack(sp[j], seg.n_rep)
                  for j in range(len(seg.body))]
        for r in range(seg.n_rep):
            for j, desc in enumerate(seg.body):
                kw = dict(positions=positions, window=window,
                          gates=_body_gates(g_reps[r], j), kv_len=kv_len,
                          training=training)
                lp = p_reps[j][r]
                if remat:
                    x = checkpoint(_layer_out, cfg, lp, desc, x, kw,
                                   use_reentrant=False)
                    continue
                x, kv = apply_layer(cfg, lp, desc, x, **kw)
                if on_layer is not None:
                    on_layer(si, j, kv)
    return x


def _layer_out(cfg, p, desc, x, kw):
    return apply_layer(cfg, p, desc, x, **kw)[0]


def run_segments_decode(cfg, segments, seg_params, x, caches, pos, *,
                        window=0, gates=None):
    """caches: per segment, {str(j): {"mixer": {"k", "v"}}} with leaves
    (n_rep, B, L, Hkv, hd), updated in place.  Returns (x, caches)."""
    for si, (seg, sp, cache) in enumerate(zip(segments, seg_params, caches)):
        g_seg = gates[si] if gates is not None else None
        for r in range(seg.n_rep):
            lg = _rep(g_seg, r)
            for j, desc in enumerate(seg.body):
                x, _ = apply_layer_decode(
                    cfg, _rep(sp[j], r), desc, x, _rep(cache[str(j)], r),
                    pos, window=window, gates=_body_gates(lg, j))
    return x, caches


# ---------------------------------------------------------------------------
# Whole-model params: client / server split
# ---------------------------------------------------------------------------


def model_plan(cfg: ModelConfig):
    """The client/server segment plans (decoder-only)."""
    s = cfg.split_layer
    return {"client_segments": build_segments(cfg, 0, s),
            "server_segments": build_segments(cfg, s, cfg.n_layers)}


def init_client_params(cfg: ModelConfig, gen, cast=None):
    """``cast``: optional, applied to each weight as it is drawn."""
    plan = model_plan(cfg)
    return {"embed": embedding_init(gen, cfg.padded_vocab(), cfg.d_model,
                                    cast),
            "segments": [segment_init(gen, cfg, s, cast)
                         for s in plan["client_segments"]]}


def init_server_params(cfg: ModelConfig, gen, cast=None):
    """``cast``: optional, applied to each weight as it is drawn."""
    plan = model_plan(cfg)
    p: Dict[str, Any] = {
        "final_norm": norm_init(cfg.d_model, cfg.norm, device=gen.device),
        "segments": [segment_init(gen, cfg, s, cast)
                     for s in plan["server_segments"]]}
    # The LM head is ALWAYS server-owned: `tie_embeddings` is model-card
    # metadata, and tying across the split would leak server weights to
    # clients.
    p["lm_head"] = embedding_init(gen, cfg.padded_vocab(), cfg.d_model, cast)
    return p


def init_params(cfg: ModelConfig, gen):
    return {"client": init_client_params(cfg, gen),
            "server": init_server_params(cfg, gen)}


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------


def _positions_for(cfg, tokens, extras=None):
    B, S = tokens.shape
    return torch.arange(S, device=tokens.device)[None, :].expand(B, S)


def _client_inputs(cfg, p, tokens, extras, dtype):
    if extras:
        _later("frontend")
    return embed(p["embed"], tokens, dtype)


def _dtype(cfg, dtype):
    return dtype or getattr(torch, cfg.dtype)


def client_forward(cfg: ModelConfig, p, tokens, extras=None, *, dtype=None,
                   window=0, training=False, remat=False):
    """Bottom (client) stack -> split activations (B, S, D).  training /
    remat: as in :func:`run_segments` (the LM trainer sets both)."""
    dtype = _dtype(cfg, dtype)
    x = _client_inputs(cfg, p, tokens, extras, dtype)
    return run_segments(cfg, model_plan(cfg)["client_segments"],
                        p["segments"], x,
                        positions=_positions_for(cfg, tokens, extras),
                        window=window, training=training, remat=remat)


def server_forward(cfg: ModelConfig, p, acts, tokens=None, extras=None, *,
                   gates=None, window=0, training=False, remat=False,
                   return_hidden=False):
    """Server stack: split activations -> float32 logits (the reference
    also returns the MoE aux loss, which a dense stack does not have).

    gates: AdaSplit per-client structured masks (see core/masks.py), a
    list aligned with the server segments.  training / remat: as in
    :func:`run_segments`.  return_hidden: skip the unembed and return
    (final-norm hidden states, router aux loss), as the reference does
    for its chunked-CE path; the aux loss of a dense stack is a float32
    zero."""
    positions = None
    if tokens is not None:
        positions = _positions_for(cfg, tokens, extras)
    x = run_segments(cfg, model_plan(cfg)["server_segments"], p["segments"],
                     acts, positions=positions, window=window, gates=gates,
                     training=training, remat=remat)
    x = apply_norm(p["final_norm"], x, cfg.norm)
    if return_hidden:
        return x, torch.zeros((), dtype=torch.float32, device=x.device)
    logits = unembed(p["lm_head"], x)
    return logits + vocab_pad_bias(cfg.vocab_size, cfg.padded_vocab(),
                                   x.device)
