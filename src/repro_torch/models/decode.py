"""Inference paths over the composed client+server model: cache init,
prefill (a cache-building forward) and single-token decode.  Port of
``repro.models.decode``.

Cache layout: ``{"client": [seg0_cache, ...], "server": [...]}``; each
segment cache has leading ``n_rep`` leaves, keyed "0".."P-1" per body
position, each entry ``{"mixer": ...}``: an attention layer's
``{"k", "v"}`` of shape ``(n_rep, B, L, Hkv, hd)`` (windowed: ring
buffers), a mamba layer's ``{"state": (n_rep, B, H, P, N) float32,
"conv": (n_rep, B, K-1, conv_dim)}``.  An encoder-decoder's cache is
``{"server": [...]}``, its decoder's alone, each layer's entry with
``cross_k``/``cross_v`` ``(n_rep, B, Sk, Hkv, hd)`` beside ``mixer``:
its prefill encodes the source once and primes the decoder with one BOS
token (slot 0 of its self-attention cache), as the reference's does.
Decode updates the cache in place.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import apply_norm, embed, unembed, \
    vocab_pad_bias
from repro_torch.models.transformer import (Segment, _client_inputs, _dtype,
                                            _positions_for, encode,
                                            model_plan, run_segments,
                                            run_segments_decode)
from repro_torch.weights import tree_map


def _seg_cache(cfg, seg: Segment, batch, cache_len, dtype, window, device,
               src_len=0):
    L = min(cache_len, window) if window else cache_len
    stack = lambda t: t.expand((seg.n_rep,) + t.shape).contiguous()

    def one(desc):
        c = attn.init_kv_cache(cfg, batch, L, dtype, device) \
            if desc.mixer == "attn" else \
            ssm_mod.init_ssm_cache(cfg, batch, dtype, device)
        out = {"mixer": {n: stack(t) for n, t in c.items()}}
        if desc.cross:
            kv = attn.init_kv_cache(cfg, batch, src_len, dtype, device)
            out.update(cross_k=stack(kv["k"]), cross_v=stack(kv["v"]))
        return out
    return {str(j): one(d) for j, d in enumerate(seg.body)}


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, *, dtype=None,
               window: int = 0, device="cuda", src_len: int = 0):
    """Zero caches; an encoder-decoder's decoder alone, its cross K/V of
    ``src_len`` encoder positions."""
    dtype = _dtype(cfg, dtype)
    plan = model_plan(cfg)
    if cfg.is_encoder_decoder:
        return {"server": [_seg_cache(cfg, s, batch, cache_len, dtype,
                                      window, device, src_len)
                           for s in plan["server_dec_segments"]]}
    return {side: [_seg_cache(cfg, s, batch, cache_len, dtype, window,
                              device)
                   for s in plan[f"{side}_segments"]]
            for side in ("client", "server")}


# ---------------------------------------------------------------------------
# Prefill
# ---------------------------------------------------------------------------


def _ring_arrange(k_full, window, cache_len):
    """Arrange prefill K/V (B, S, H, hd) into the decode cache layout.

    Windowed: the last ``window`` positions in ring-slot order.  Full:
    padded with zero rows up to ``cache_len`` so decode can append."""
    S = k_full.shape[1]
    if window and S > window:
        last = k_full[:, S - window:]
        slots = (torch.arange(window, device=k_full.device)
                 + (S - window)) % window
        out = torch.zeros_like(last)
        out[:, slots] = last
        return out
    L = max(cache_len, S) if not window else max(window, S)
    if L > S:
        pad = k_full.new_zeros((k_full.shape[0], L - S) + k_full.shape[2:])
        return torch.cat([k_full, pad], dim=1)
    return k_full


def run_segments_prefill(cfg, segments, seg_params, x, *, positions,
                         window=0, gates=None, cache_len=0, kv_len=None,
                         cross=None):
    """Like ``run_segments`` but also emits per-layer caches: an attention
    layer's K/V arranged for decode, a mamba layer's final state and
    conv tail, a decoder layer's cross K/V over ``cross`` (the encoder
    states).

    kv_len: optional (B,) int32 valid-key count per row for ragged
    right-padded prompts, applied to every self-attention (the
    reference's prefix ``kv_valid``; never to a cross-attention, whose
    keys are the encoder's).  Returns (x, caches)."""
    per_layer: Dict[Any, Any] = {}

    def stash(si, j, cache):
        mixer = cache["mixer"]
        if not isinstance(mixer, dict):             # attention: (k, v)
            mixer = {name: _ring_arrange(t, window, cache_len)
                     for name, t in zip(("k", "v"), mixer)}
        per_layer.setdefault((si, j), []).append(dict(cache, mixer=mixer))

    x, _ = run_segments(cfg, segments, seg_params, x, positions=positions,
                        window=window, gates=gates, kv_len=kv_len,
                        on_layer=stash, cross=cross)
    caches = [{str(j): tree_map(lambda *ts: torch.stack(ts),
                                *per_layer[(si, j)])
               for j in range(len(seg.body))}
              for si, seg in enumerate(segments)]
    return x, caches


def prefill(cfg: ModelConfig, params, tokens, extras=None, *, gates=None,
            window: int = 0, dtype=None, cache_len: int = 0,
            last_index=None):
    """Build the cache from a prompt.  Returns (last_logits, cache).

    gates: optional per-server-segment AdaSplit masks — leaves either
    (n_rep, U) for one client shared across the batch, or (n_rep, B, U)
    per example (``masks.expand_gates`` / ``masks.stack_client_gates``).

    last_index: optional (B,) int index of each example's LAST REAL
    token for ragged right-padded prompts: the logits are taken there,
    and keys past it are masked out of every self-attention
    (``kv_len = last_index + 1``), so a ragged batch prefill equals
    prefilling each prompt alone.  A stack with mamba layers takes no
    ``last_index`` (their state would fold the pad tokens in).

    An encoder-decoder encodes ``extras["src_embeds"]`` (B, Sk, D) and
    primes its decoder with one BOS token (id 0, position 0): the
    logits are the BOS step's, the self-attention caches hold it at
    slot 0 (``cache_len`` defaults to S + 64, S the prompt's length) and
    each decoder layer's cross K/V are stashed.  ``tokens`` give only
    the batch and S there, and ``last_index`` is ignored, as in the
    reference."""
    dtype = _dtype(cfg, dtype)
    plan = model_plan(cfg)
    pc, ps = params["client"], params["server"]
    if cfg.is_encoder_decoder:
        src = _client_inputs(cfg, pc, tokens, extras, dtype)
        enc, _ = run_segments(cfg, plan["client_segments"], pc["segments"],
                              src)
        enc = encode(cfg, ps, enc)
        B = tokens.shape[0]
        bos = torch.zeros((B, 1), dtype=torch.long, device=tokens.device)
        x, caches = run_segments_prefill(
            cfg, plan["server_dec_segments"], ps["segments"],
            embed(ps["dec_embed"], bos, dtype), positions=bos,
            window=window, gates=gates, cross=enc,
            cache_len=cache_len or tokens.shape[1] + 64)
        return _logits(cfg, ps, x[:, -1:]), {"server": caches}
    positions = _positions_for(cfg, tokens, extras)
    x = _client_inputs(cfg, pc, tokens, extras, dtype)
    cache_len = cache_len or tokens.shape[1] + 64
    kv_len = None
    if last_index is not None:
        if not slot_serving_ok(cfg):
            raise ValueError(f"{cfg.name}: an SSM stack cannot prefill a "
                             "ragged right-padded batch")
        last_index = torch.as_tensor(last_index, device=tokens.device)
        kv_len = (last_index + 1).to(torch.int32)
    x, c_caches = run_segments_prefill(
        cfg, plan["client_segments"], pc["segments"], x,
        positions=positions, window=window, cache_len=cache_len,
        kv_len=kv_len)
    x, s_caches = run_segments_prefill(
        cfg, plan["server_segments"], ps["segments"], x,
        positions=positions, window=window, gates=gates,
        cache_len=cache_len, kv_len=kv_len)
    x_last = x[:, -1:] if last_index is None else \
        x[torch.arange(x.shape[0], device=x.device), last_index][:, None]
    return _logits(cfg, ps, x_last), {"client": c_caches, "server": s_caches}


def _logits(cfg, ps, x):
    """The server's final norm, LM head and vocab pad bias on (B, 1, D)
    hidden states -> float32 logits."""
    x = apply_norm(ps["final_norm"], x, cfg.norm)
    return unembed(ps["lm_head"], x) + vocab_pad_bias(
        cfg.vocab_size, cfg.padded_vocab(), x.device)


def slot_serving_ok(cfg: ModelConfig) -> bool:
    """Whether the arch supports ragged / per-slot batches: decoder-only
    attention stacks (SSM state folds pad tokens in irreversibly, and an
    encoder-decoder's decoder has no ragged prompt axis)."""
    if cfg.is_encoder_decoder or cfg.is_conv:
        return False
    plan = model_plan(cfg)
    return all(d.mixer == "attn"
               for seg in plan["client_segments"] + plan["server_segments"]
               for d in seg.body)


def merge_slot_cache(batch_cache, one_cache, slot: int):
    """Write a single-request cache (leaves ``(n_rep, 1, L, Hkv, hd)``)
    into row ``slot`` of the persistent batch cache (leaves
    ``(n_rep, B, L, Hkv, hd)``), in place, and return the batch cache.

    The admission step of the continuous-batching engine: a freed
    slot's whole cache row is overwritten by the next request's prefill
    cache, so the two must have one length (prefill with the batch
    cache's ``cache_len``).  A device-to-device copy per leaf, no host
    sync."""
    tree_map(lambda b, s: b[:, slot].copy_(s[:, 0]), batch_cache, one_cache)
    return batch_cache


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def decode_step(cfg: ModelConfig, params, token, cache, pos, *, gates=None,
                window: int = 0, dtype=None):
    """One token for the whole (composed) model.

    token: (B, 1) int; pos: a scalar current position, or a (B,) tensor
    of PER-SLOT positions (each row decodes at its own context length,
    see ``attention.attn_decode``).  gates apply to the server segments
    only; as in :func:`prefill`, leaves may carry a per-example B axis.
    The cache is updated in place.  Returns (logits (B, 1, V), cache).
    An encoder-decoder steps its decoder alone, over the cross K/V its
    prefill stashed."""
    dtype = _dtype(cfg, dtype)
    plan = model_plan(cfg)
    pc, ps = params["client"], params["server"]
    if cfg.is_encoder_decoder:
        x, caches = run_segments_decode(
            cfg, plan["server_dec_segments"], ps["segments"],
            embed(ps["dec_embed"], token, dtype), cache["server"], pos,
            window=window, gates=gates)
        return _logits(cfg, ps, x), {"server": caches}
    x = embed(pc["embed"], token, dtype)
    x, c_caches = run_segments_decode(
        cfg, plan["client_segments"], pc["segments"], x, cache["client"],
        pos, window=window)
    x, s_caches = run_segments_decode(
        cfg, plan["server_segments"], ps["segments"], x, cache["server"],
        pos, window=window, gates=gates)
    return _logits(cfg, ps, x), {"client": c_caches, "server": s_caches}
