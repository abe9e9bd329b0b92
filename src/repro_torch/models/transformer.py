"""Decoder-only LM stack: dense, MoE, SSM (mamba2) and hybrid (jamba)
layers (port of ``repro.models.transformer``).

The stack is organised into **segments**: maximal runs of layers whose
(mixer, ffn) pattern repeats with period P (the lcm of the attention
and MoE interleave periods).  Segment params are stacked with a leading
``n_rep`` axis as in the reference, and the reference's scan over
``n_rep`` is a Python loop here.  AdaSplit's client/server split slices
the stack at ``cfg.split_layer`` (block-aligned for hybrids) and
re-segments each side.

Mixers are ``attn`` (GQA, the flash kernel at prefill) and ``ssm``
(``models.ssm``); ffns ``dense``, ``moe`` and ``none``.  The MoE
router's aux loss is summed over every layer in order, as the
reference's scan carries it, and the trainer adds ``router_aux_coef``
times it to the server loss.  The cross-attention and
modality-frontend branches raise ``NotImplementedError`` naming the
slice that brings them.
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
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (apply_norm, embed, embedding_init,
                                       norm_init, unembed, vocab_pad_bias)
from repro_torch.weights import tree_unstack

_LATER = {"cross": "the encoder-decoder slice",
          "frontend": "the multimodal (audio / vision) slice"}


def _later(what: str):
    raise NotImplementedError(f"{what} is not ported yet: it comes with "
                              f"{_LATER[what]}")


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
    if desc.cross:
        _later("cross")


def _layer_init(gen, cfg: ModelConfig, desc: LayerDesc, n_rep: int,
                cast=None):
    """One body position's params, stacked over ``n_rep``; ``cast``, where
    given, applied to each weight as it is drawn."""
    _check_layer(desc)
    lead = (n_rep,)
    mixer = attn.attention_init if desc.mixer == "attn" else \
        ssm_mod.mamba_init
    p: Dict[str, Any] = {"norm1": norm_init(cfg.d_model, cfg.norm, lead,
                                            gen.device),
                         "mixer": mixer(gen, cfg, lead, cast)}
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
    (B, E) gate as it comes).  Returns (x, the router's aux loss, or
    None where the layer has no router: the reference adds a zero
    there, which changes no sum)."""
    if desc.ffn == "none":
        return x, None
    h = apply_norm(p["norm2"], x, cfg.norm)
    gate = _gate_or_none(gates, "ffn")
    if desc.ffn == "moe":
        y, aux = moe_mod.moe_forward(p["ffn"], h, cfg, expert_gate=gate)
        return x + y, aux
    return x + mlp_mod.mlp_forward(p["ffn"], h,
                                   unit_gate=_unit_gate(gate, x.dtype)), None


def apply_layer(cfg: ModelConfig, p, desc: LayerDesc, x, *, positions=None,
                window=0, gates=None, kv_len=None, training=False,
                want_cache=False):
    """Full-sequence layer.  Returns (x, cache, aux): the MoE router's
    aux loss (float32; None without a router) and the layer's decode
    cache as prefill stashes it: an attention layer's (k, v), a mamba
    mixer's ``{"state", "conv"}`` where ``want_cache`` (else None).
    ``training`` takes the differentiable training attention in
    place of the flash kernel (``attn.attn_forward``); ``kv_len`` masks
    the keys of ragged rows, and an SSM mixer takes no ragged rows (its
    state would fold the pad tokens in: the engines never form one)."""
    _check_layer(desc)
    h = apply_norm(p["norm1"], x, cfg.norm)
    gate = _gate_or_none(gates, "mixer")
    if desc.mixer == "attn":
        out, cache = attn.attn_forward(p["mixer"], h, cfg,
                                       positions=positions,
                                       causal=desc.causal, window=window,
                                       head_gate=gate, kv_len=kv_len,
                                       training=training)
    else:
        out = ssm_mod.mamba_forward(p["mixer"], h, cfg,
                                    unit_gate=_unit_gate(gate, x.dtype),
                                    return_state=want_cache)
        out, cache = out if want_cache else (out, None)
    x, aux = _ffn(cfg, p, desc, x + out, gates)
    return x, cache, aux


def apply_layer_decode(cfg: ModelConfig, p, desc: LayerDesc, x, cache, pos,
                       *, window=0, gates=None):
    """One-token layer step; the cache is updated in place.  Returns
    (x, new_cache)."""
    _check_layer(desc)
    h = apply_norm(p["norm1"], x, cfg.norm)
    new_cache = dict(cache)
    gate = _gate_or_none(gates, "mixer")
    if desc.mixer == "attn":
        out, new_cache["mixer"] = attn.attn_decode(
            p["mixer"], h, cache["mixer"], pos, cfg, window=window,
            head_gate=gate)
    else:
        out, new_cache["mixer"] = ssm_mod.mamba_decode(
            p["mixer"], h, cache["mixer"], cfg,
            unit_gate=_unit_gate(gate, x.dtype))
    return _ffn(cfg, p, desc, x + out, gates)[0], new_cache


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
    on_layer(si, j, cache): optional hook called with every layer's
    decode cache (``apply_layer``'s), in order (prefill stashes its
    cache through it).
    training: every layer on the differentiable training attention.
    remat: each layer under ``torch.utils.checkpoint`` (its activations
    recomputed in the backward pass, the reference's ``jax.checkpoint``
    of each scan step; the checkpointed function returns the layer's
    aux too, so the router's aux gradient survives it); no ``on_layer``
    hook with it.  Returns (x, aux): the router aux losses summed over
    the layers in order, as the reference's scan carries them (a
    float32 zero for a stack without a router)."""
    if remat and on_layer is not None:
        raise ValueError("remat keeps no layer's cache for on_layer")
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
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
                    x, a = checkpoint(_layer_out, cfg, lp, desc, x, kw,
                                      use_reentrant=False)
                else:
                    x, cache, a = apply_layer(cfg, lp, desc, x,
                                              want_cache=on_layer is not None,
                                              **kw)
                    if on_layer is not None:
                        on_layer(si, j, cache)
                if a is not None:
                    aux = aux + a
    return x, aux


def _layer_out(cfg, p, desc, x, kw):
    x, _, aux = apply_layer(cfg, p, desc, x, **kw)
    return x, aux


def run_segments_decode(cfg, segments, seg_params, x, caches, pos, *,
                        window=0, gates=None):
    """caches: per segment, {str(j): {"mixer": ...}}: an attention
    layer's {"k", "v"} with leaves (n_rep, B, L, Hkv, hd), a mamba
    layer's {"state": (n_rep, B, H, P, N), "conv": (n_rep, B, K-1, C)},
    updated in place.  Returns (x, caches)."""
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
    # the client's router aux stays out of its loss, as in the reference
    return run_segments(cfg, model_plan(cfg)["client_segments"],
                        p["segments"], x,
                        positions=_positions_for(cfg, tokens, extras),
                        window=window, training=training, remat=remat)[0]


def server_forward(cfg: ModelConfig, p, acts, tokens=None, extras=None, *,
                   gates=None, window=0, training=False, remat=False,
                   return_hidden=False):
    """Server stack: split activations -> float32 logits (the reference
    also returns the MoE aux loss; ``return_hidden`` returns it here).

    gates: AdaSplit per-client structured masks (see core/masks.py), a
    list aligned with the server segments.  training / remat: as in
    :func:`run_segments`.  return_hidden: skip the unembed and return
    (final-norm hidden states, router aux loss), as the reference does
    for its chunked-CE path: the aux summed over the server's layers (a
    float32 zero for a stack without a router)."""
    positions = None
    if tokens is not None:
        positions = _positions_for(cfg, tokens, extras)
    x, aux = run_segments(cfg, model_plan(cfg)["server_segments"],
                          p["segments"], acts, positions=positions,
                          window=window, gates=gates, training=training,
                          remat=remat)
    x = apply_norm(p["final_norm"], x, cfg.norm)
    if return_hidden:
        return x, aux
    logits = unembed(p["lm_head"], x)
    return logits + vocab_pad_bias(cfg.vocab_size, cfg.padded_vocab(),
                                   x.device)
