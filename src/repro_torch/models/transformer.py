"""LM stack over every family: decoder-only dense, MoE, SSM (mamba2),
hybrid (jamba) and vision-text (qwen2-vl) stacks, and the
encoder-decoder (seamless) one (port of ``repro.models.transformer``).

The stack is organised into **segments**: maximal runs of layers whose
(mixer, ffn) pattern repeats with period P (the lcm of the attention
and MoE interleave periods).  Segment params are stacked with a leading
``n_rep`` axis as in the reference, and the reference's scan over
``n_rep`` is a Python loop here.  AdaSplit's client/server split slices
the stack at ``cfg.split_layer`` (block-aligned for hybrids) and
re-segments each side; an encoder-decoder's client holds the bottom
``split_layer`` encoder layers, its server the rest of the encoder and
the whole decoder.

Mixers are ``attn`` (GQA, the flash kernel at prefill; an encoder's
non-causal) and ``ssm`` (``models.ssm``); ffns ``dense``, ``moe`` and
``none``.  A decoder layer of an encoder-decoder (``cross=True``) adds
a cross-attention over the encoder states between its self-attention
and its ffn (``attention.cross_attention``, never the flash kernel).
The MoE router's aux loss is summed over every layer in order, as the
reference's scan carries it, and the trainer adds ``router_aux_coef``
times it to the server loss.

The modality frontends are stubs, as in the reference: precomputed
frame embeddings (``extras["src_embeds"]``, (B, S, D)) enter an
encoder-decoder's encoder through the client's ``frontend_proj``; a
vision-text client projects ``extras["vision_embeds"]`` (B, F, D)
likewise and splices them over the first F token embeddings (only
where S >= F: a shorter prompt takes none, silently, as in the
reference), and its M-RoPE reads ``extras["positions"]`` (B, S, 3)
(the (t, h, w) streams; without them all three are ``arange(S)``).
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
from repro_torch.models.layers import (apply_norm, dense_init, embed,
                                       embedding_init, norm_init, unembed,
                                       vocab_pad_bias)
from repro_torch.weights import tree_unstack


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


def _desc(cfg: ModelConfig, i: int, *, decoder=False,
          encoder=False) -> LayerDesc:
    if encoder:
        return LayerDesc("attn", "dense", cross=False, causal=False)
    if decoder and cfg.is_encoder_decoder:
        return LayerDesc("attn", "dense", cross=True, causal=True)
    mixer = "attn" if (cfg.n_heads and cfg.is_attn_layer(i)) else "ssm"
    if cfg.is_moe_layer(i):
        ffn = "moe"
    elif cfg.d_ff:
        ffn = "dense"
    else:
        ffn = "none"
    return LayerDesc(mixer, ffn)


def build_segments(cfg: ModelConfig, start: int, end: int, *,
                   decoder=False, encoder=False) -> List[Segment]:
    """Segment plan for layers [start, end) (of the encoder or of an
    encoder-decoder's decoder where asked)."""
    if start >= end:
        return []
    segs: List[Segment] = []
    i = start
    # an unrolled prefix for first_k_dense's irregular layers
    while i < min(end, cfg.first_k_dense) and not (decoder or encoder):
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
    kind = dict(decoder=decoder, encoder=encoder)
    if n_rep:
        segs.append(Segment(n_rep, tuple(_desc(cfg, i + k, **kind)
                                         for k in range(P))))
        i += n_rep * P
    for k in range(tail):
        segs.append(Segment(1, (_desc(cfg, i + k, **kind),)))
    return segs


# ---------------------------------------------------------------------------
# Param init
# ---------------------------------------------------------------------------


def _layer_init(gen, cfg: ModelConfig, desc: LayerDesc, n_rep: int,
                cast=None):
    """One body position's params, stacked over ``n_rep``; ``cast``, where
    given, applied to each weight as it is drawn."""
    lead = (n_rep,)
    mixer = attn.attention_init if desc.mixer == "attn" else \
        ssm_mod.mamba_init
    p: Dict[str, Any] = {"norm1": norm_init(cfg.d_model, cfg.norm, lead,
                                            gen.device),
                         "mixer": mixer(gen, cfg, lead, cast)}
    if desc.cross:
        p["norm_x"] = norm_init(cfg.d_model, cfg.norm, lead, gen.device)
        p["cross"] = attn.attention_init(gen, cfg, lead, cast)
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
                cross=None, want_cache=False):
    """Full-sequence layer.  Returns (x, cache, aux): the MoE router's
    aux loss (float32; None without a router) and, where
    ``want_cache`` (else None), the layer's decode cache as prefill
    stashes it: ``{"mixer": ...}``, an attention layer's (k, v) or a
    mamba mixer's ``{"state", "conv"}``, and a decoder layer's
    ``cross_k``/``cross_v``.  ``training`` takes the differentiable
    training attention in place of the flash kernel
    (``attn.attn_forward``); ``kv_len`` masks the keys of ragged rows
    (of the self-attention only), and an SSM mixer takes no ragged rows
    (its state would fold the pad tokens in: the engines never form
    one).  ``cross``: the raw encoder states (B, Sk, D) a decoder layer
    attends to; each layer projects its own K/V from them."""
    h = apply_norm(p["norm1"], x, cfg.norm)
    gate = _gate_or_none(gates, "mixer")
    if desc.mixer == "attn":
        out, mixer = attn.attn_forward(p["mixer"], h, cfg,
                                       positions=positions,
                                       causal=desc.causal, window=window,
                                       head_gate=gate, kv_len=kv_len,
                                       training=training)
    else:
        out = ssm_mod.mamba_forward(p["mixer"], h, cfg,
                                    unit_gate=_unit_gate(gate, x.dtype),
                                    return_state=want_cache)
        out, mixer = out if want_cache else (out, None)
    x = x + out
    cache = {"mixer": mixer} if want_cache else None
    if desc.cross:
        h = apply_norm(p["norm_x"], x, cfg.norm)
        ck, cv = attn.cross_kv(p["cross"], cross, cfg, x.dtype)
        out, _ = attn.attn_forward(p["cross"], h, cfg, positions=None,
                                   kv_override=(ck, cv))
        x = x + out
        if want_cache:
            cache.update(cross_k=ck, cross_v=cv)
    x, aux = _ffn(cfg, p, desc, x, gates)
    return x, cache, aux


def apply_layer_decode(cfg: ModelConfig, p, desc: LayerDesc, x, cache, pos,
                       *, window=0, gates=None):
    """One-token layer step; the cache is updated in place (a decoder
    layer's ``cross_k``/``cross_v`` only read).  Returns
    (x, new_cache)."""
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
    x = x + out
    if desc.cross:
        h = apply_norm(p["norm_x"], x, cfg.norm)
        out, _ = attn.attn_decode(p["cross"], h, None, pos, cfg,
                                  kv_override=(cache["cross_k"],
                                               cache["cross_v"]))
        x = x + out
    return _ffn(cfg, p, desc, x, gates)[0], new_cache


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
                 remat=False, cross=None):
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
    hook with it.  cross: the encoder states a decoder's layers attend
    to.  Returns (x, aux): the router aux losses summed over
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
                          training=training, cross=cross)
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
    updated in place; a decoder layer's also ``cross_k``/``cross_v``
    (n_rep, B, Sk, Hkv, hd).  Returns (x, caches)."""
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
    """The client/server segment plans: ``client_segments`` and
    ``server_segments``; an encoder-decoder's ``client_segments`` (the
    bottom of the encoder), ``server_enc_segments`` (the rest of it) and
    ``server_dec_segments`` (the decoder)."""
    s = cfg.split_layer
    if cfg.is_encoder_decoder:
        return {"client_segments": build_segments(cfg, 0, s, encoder=True),
                "server_enc_segments": build_segments(
                    cfg, s, cfg.n_encoder_layers, encoder=True),
                "server_dec_segments": build_segments(
                    cfg, 0, cfg.n_layers, decoder=True)}
    return {"client_segments": build_segments(cfg, 0, s),
            "server_segments": build_segments(cfg, s, cfg.n_layers)}


def server_plan(cfg: ModelConfig):
    """The segments of the server's ``segments`` params, the ones its
    masks gate: the decoder's for an encoder-decoder."""
    return model_plan(cfg)["server_dec_segments" if cfg.is_encoder_decoder
                           else "server_segments"]


def init_client_params(cfg: ModelConfig, gen, cast=None):
    """``cast``: optional, applied to each weight as it is drawn.  A text
    or vision-text client has the token embedding; an audio or
    vision-text one the frontend projector of the stub's embeddings
    (an encoder-decoder's client has no token embedding)."""
    plan = model_plan(cfg)
    p: Dict[str, Any] = {}
    if cfg.modality == "text" or not cfg.is_encoder_decoder:
        p["embed"] = embedding_init(gen, cfg.padded_vocab(), cfg.d_model,
                                    cast)
    if cfg.modality in ("audio", "vision_text"):
        p["frontend_proj"] = dense_init(gen, cfg.d_model, cfg.d_model,
                                        cast=cast)
    p["segments"] = [segment_init(gen, cfg, s, cast)
                     for s in plan["client_segments"]]
    return p


def init_server_params(cfg: ModelConfig, gen, cast=None):
    """``cast``: optional, applied to each weight as it is drawn.  An
    encoder-decoder's server also holds the rest of the encoder
    (``enc_segments``, ``enc_final_norm``) and the decoder's token
    embedding (``dec_embed``); ``segments`` are the decoder's."""
    plan = model_plan(cfg)
    p: Dict[str, Any] = {
        "final_norm": norm_init(cfg.d_model, cfg.norm, device=gen.device)}
    if cfg.is_encoder_decoder:
        p["enc_segments"] = [segment_init(gen, cfg, s, cast)
                             for s in plan["server_enc_segments"]]
        p["enc_final_norm"] = norm_init(cfg.d_model, cfg.norm,
                                        device=gen.device)
        p["dec_embed"] = embedding_init(gen, cfg.padded_vocab(),
                                        cfg.d_model, cast)
    p["segments"] = [segment_init(gen, cfg, s, cast)
                     for s in server_plan(cfg)]
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
    """(B, S) positions, or under M-RoPE (B, S, 3): ``extras["positions"]``
    where given, else ``arange(S)`` on all three streams."""
    B, S = tokens.shape
    if cfg.mrope_sections:
        if extras is not None and "positions" in extras:
            return extras["positions"]
        return torch.arange(S, device=tokens.device)[None, :, None] \
            .expand(B, S, 3)
    return torch.arange(S, device=tokens.device)[None, :].expand(B, S)


def _client_inputs(cfg, p, tokens, extras, dtype):
    """The client stack's input: an encoder-decoder's frame embeddings
    through ``frontend_proj``; else the token embeddings, a vision-text
    client's patch embeddings (through ``frontend_proj``) spliced over
    the first F of them where S >= F."""
    if cfg.is_encoder_decoder:
        src = extras["src_embeds"].to(dtype)
        return src @ p["frontend_proj"].to(dtype)
    x = embed(p["embed"], tokens, dtype)
    if cfg.modality == "vision_text" and extras is not None \
            and "vision_embeds" in extras:
        ve = extras["vision_embeds"].to(dtype) @ p["frontend_proj"].to(dtype)
        F = ve.shape[1]
        if x.shape[1] >= F:
            x = torch.cat([ve, x[:, F:]], dim=1)
    return x


def _dtype(cfg, dtype):
    return dtype or getattr(torch, cfg.dtype)


def client_forward(cfg: ModelConfig, p, tokens, extras=None, *, dtype=None,
                   window=0, training=False, remat=False):
    """Bottom (client) stack -> split activations (B, S, D) (an
    encoder-decoder's: of its encoder, without positions).  training /
    remat: as in :func:`run_segments` (the LM trainer sets both)."""
    dtype = _dtype(cfg, dtype)
    x = _client_inputs(cfg, p, tokens, extras, dtype)
    positions = None if cfg.is_encoder_decoder else \
        _positions_for(cfg, tokens, extras)
    # the client's router aux stays out of its loss, as in the reference
    return run_segments(cfg, model_plan(cfg)["client_segments"],
                        p["segments"], x, positions=positions,
                        window=window, training=training, remat=remat)[0]


def encode(cfg: ModelConfig, p, acts, *, training=False, remat=False):
    """An encoder-decoder server's encoder half: the client's split
    activations through ``enc_segments`` and ``enc_final_norm`` -> the
    encoder states the decoder attends to."""
    enc, _ = run_segments(cfg, model_plan(cfg)["server_enc_segments"],
                          p["enc_segments"], acts, training=training,
                          remat=remat)
    return apply_norm(p["enc_final_norm"], enc, cfg.norm)


def server_forward(cfg: ModelConfig, p, acts, tokens=None, extras=None, *,
                   gates=None, window=0, training=False, remat=False,
                   return_hidden=False):
    """Server stack: split activations -> float32 logits (the reference
    also returns the MoE aux loss; ``return_hidden`` returns it here).

    An encoder-decoder's server encodes ``acts`` (``encode``) and runs
    its decoder on ``tokens`` over them.  gates: AdaSplit per-client
    structured masks (see core/masks.py), a list aligned with the
    server's (decoder) segments.  training / remat: as in
    :func:`run_segments`.  return_hidden: skip the unembed and return
    (final-norm hidden states, router aux loss), as the reference does
    for its chunked-CE path: the aux summed over the server's layers (a
    float32 zero for a stack without a router)."""
    positions = None
    if tokens is not None:
        positions = _positions_for(cfg, tokens, extras)
    cross = None
    x = acts
    if cfg.is_encoder_decoder:
        cross = encode(cfg, p, acts, training=training, remat=remat)
        x = embed(p["dec_embed"], tokens, acts.dtype)
    x, aux = run_segments(cfg, server_plan(cfg), p["segments"], x,
                          positions=positions, window=window, gates=gates,
                          training=training, remat=remat, cross=cross)
    x = apply_norm(p["final_norm"], x, cfg.norm)
    if return_hidden:
        return x, aux
    logits = unembed(p["lm_head"], x)
    return logits + vocab_pad_bias(cfg.vocab_size, cfg.padded_vocab(),
                                   x.device)
