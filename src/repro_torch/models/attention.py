"""GQA attention: init, full-sequence forward (train / prefill /
encoder), cross-attention over encoder states, and single-token decode
with an (optionally windowed ring-buffer) KV cache.  Port of
``repro.models.attention``: RoPE, or qwen2-vl's M-RoPE over (t, h, w)
position streams.

Every full-sequence self-attention goes through
``kernels.flash_attention`` (the CUDA kernel on the card), ragged
batches and an encoder's non-causal attention included: where the
reference masks keys with ``kv_valid`` and leaves its flash path for
the einsum one, the port passes the prefix length ``kv_len`` to the
kernel.  Where the reference takes ``mha_chunked`` (S > 2048, S % 256
== 0, no key mask), the port rounds q, k and v to bf16 as it does, and
runs ``mha_chunked`` on the CPU and the bf16 flash kernel on the card
(``chunked_attention``).  Cross-attention (``kv_override``: queries of
the decoder, keys and values of the encoder, Sq != Sk) never reaches
the flash kernel, which takes one S: it takes the reference's choice,
``mha_einsum``, or ``mha_chunked`` above Sq = 2048 (Sq % 256 == 0), in
torch ops on the card as on the CPU (``cross_attention``).  Decode
attention is ``mha_einsum`` in plain torch ops, as in the reference
(one query row per step).

The flash kernel has no backward, as the reference's Pallas kernel has
none, and refuses inputs that need a gradient.  The LM trainer asks
``attn_forward`` for the reference's training attention instead
(``training=True``): ``mha_einsum``, or ``mha_chunked`` where the
reference takes it, in torch ops that autograd differentiates, on the
card as on the CPU.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.layers import apply_mrope, apply_rope, dense_init

NEG_INF = -1e30


def attention_init(gen, cfg, lead=(), cast=None):
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": dense_init(gen, d, hq * hd, lead=lead, cast=cast),
        "wk": dense_init(gen, d, hkv * hd, lead=lead, cast=cast),
        "wv": dense_init(gen, d, hkv * hd, lead=lead, cast=cast),
        "wo": dense_init(gen, hq * hd, d, lead=lead, cast=cast),
    }
    if cfg.qkv_bias:
        for name, n in (("bq", hq), ("bk", hkv), ("bv", hkv)):
            p[name] = torch.zeros(tuple(lead) + (n * hd,), device=gen.device)
    return p


def _project(p, x, cfg, dtype, which="qkv"):
    """The projections of x (B, S, D) that ``which`` names, of "q", "k"
    and "v" in that order: a list of (B, S, H, hd), H the heads of each."""
    B, S, _ = x.shape
    out = []
    for n in which:
        y = x @ p["w" + n].to(dtype)
        if cfg.qkv_bias:
            y = y + p["b" + n].to(dtype)
        out.append(y.reshape(B, S, -1, cfg.head_dim))
    return out


def _rope_qk(q, k, cfg, positions):
    """RoPE on q and k: M-RoPE where the config has sections (positions
    (B, S, 3)), else plain RoPE where ``rope_theta`` > 0 (positions
    (B, S)); none without positions (an encoder, a cross-attention)."""
    if positions is None:
        return q, k
    if cfg.mrope_sections:
        return tuple(apply_mrope(t, positions, cfg.rope_theta,
                                 cfg.mrope_sections) for t in (q, k))
    if cfg.rope_theta > 0:
        return (apply_rope(q, positions, cfg.rope_theta),
                apply_rope(k, positions, cfg.rope_theta))
    return q, k


# ---------------------------------------------------------------------------
# Core attention math
# ---------------------------------------------------------------------------


def mha_einsum(q, k, v, *, causal: bool, window: int = 0,
               q_offset: int = 0, kv_valid: Optional[torch.Tensor] = None):
    """Plain attention in float32 (decode / oracle).

    q: (B, Sq, Hq, hd); k, v: (B, Sk, Hkv, hd); kv_valid: optional
    (B, Sk) bool key mask.  GQA by repeating kv heads."""
    B, Sq, Hq, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qf = q.to(torch.float32)
    kf = k.to(torch.float32).repeat_interleave(G, dim=2)
    vf = v.to(torch.float32).repeat_interleave(G, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", qf, kf) / (hd ** 0.5)
    qpos = torch.arange(Sq, device=q.device) + q_offset
    kpos = torch.arange(Sk, device=q.device)
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window:
        mask &= kpos[None, :] > qpos[:, None] - window
    scores = scores.masked_fill(~mask, NEG_INF)
    if kv_valid is not None:
        scores = scores.masked_fill(~kv_valid[:, None, None, :], NEG_INF)
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w, vf).to(q.dtype)


def mha_chunked(q, k, v, *, causal: bool, window: int = 0,
                q_chunk: int = 1024, kv_chunk: int = 1024):
    """The reference's online-softmax attention over (q_chunk, kv_chunk)
    blocks: q, k and v rounded to bf16, their dots summed in float32,
    P rounded to bf16 before the value product, float32 running max,
    sum and accumulator; the output cast back to q's dtype.

    q: (B, Sq, Hq, hd); k, v: (B, Skv, Hkv, hd); each S a multiple of
    its chunk (the reference's assertion)."""
    B, Sq, Hq, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    q_chunk, kv_chunk = min(q_chunk, Sq), min(kv_chunk, Skv)
    if Sq % q_chunk or Skv % kv_chunk:
        raise ValueError(f"S {Sq}/{Skv} not a multiple of the chunks "
                         f"{q_chunk}/{kv_chunk}")
    f32, bf16 = torch.float32, torch.bfloat16
    # bf16 inputs, f32 products and sums (exact products of bf16 values)
    qf = q.to(bf16).to(f32)
    kf = k.to(bf16).to(f32).repeat_interleave(G, dim=2)
    vf = v.to(bf16).to(f32).repeat_interleave(G, dim=2)
    scale = 1.0 / math.sqrt(hd)
    outs = []
    for q0 in range(0, Sq, q_chunk):
        qblk = qf[:, q0:q0 + q_chunk]
        qpos = q0 + torch.arange(q_chunk, device=q.device)
        m = torch.full((B, Hq, q_chunk), NEG_INF, dtype=f32, device=q.device)
        l = torch.zeros((B, Hq, q_chunk), dtype=f32, device=q.device)
        acc = torch.zeros((B, Hq, q_chunk, hd), dtype=f32, device=q.device)
        for k0 in range(0, Skv, kv_chunk):
            kpos = k0 + torch.arange(kv_chunk, device=q.device)
            s = torch.einsum("bqhd,bkhd->bhqk", qblk,
                             kf[:, k0:k0 + kv_chunk]) * scale
            msk = torch.ones((q_chunk, kv_chunk), dtype=torch.bool,
                             device=q.device)
            if causal:
                msk &= kpos[None, :] <= qpos[:, None]
            if window:
                msk &= kpos[None, :] > qpos[:, None] - window
            s = torch.where(msk, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", p.to(bf16).to(f32),
                vf[:, k0:k0 + kv_chunk])
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(out.transpose(1, 2))
    return torch.cat(outs, dim=1).to(q.dtype)


def _chunk(n: int) -> int:
    """The reference's block of ``min(1024, n)`` where that divides n, else
    the largest block of at most 1024 that does (where the reference's
    chunk assertion fails)."""
    return n if n <= 1024 else math.gcd(n, 1024)


def chunked_attention(q, k, v, *, causal: bool, window: int = 0):
    """The reference's long-sequence attention on (B, S, H, hd) q, k, v:
    the inputs rounded to bf16, the output cast back to q's dtype.  On
    CPU tensors ``mha_chunked`` in blocks of ``_chunk(S)``.  On CUDA
    tensors the bf16 flash kernel on the rounded inputs (its P kept to
    ~16 bits, where ``mha_chunked`` rounds P to 8)."""
    if q.device.type == "cpu":
        chunk = _chunk(q.shape[1])
        return mha_chunked(q, k, v, causal=causal, window=window,
                           q_chunk=chunk, kv_chunk=chunk)
    bf16 = torch.bfloat16
    out = flash_attention(q.to(bf16).transpose(1, 2),
                          k.to(bf16).transpose(1, 2),
                          v.to(bf16).transpose(1, 2), causal=causal,
                          window=window)
    return out.transpose(1, 2).to(q.dtype)


# ---------------------------------------------------------------------------
# Layer-level entry points
# ---------------------------------------------------------------------------


def _project_out(p, out, gate, dtype):
    """The wo projection of (B, S, H, hd) head outputs, each head first
    gated by the AdaSplit per-head server mask: gate (H,) for one client
    or (B, H) per example."""
    B, S = out.shape[:2]
    if gate is not None:
        g = gate.to(dtype)
        out = out * (g[None, None, :, None] if g.ndim == 1
                     else g[:, None, :, None])
    return out.reshape(B, S, -1) @ p["wo"].to(dtype)


def training_attention(q, k, v, *, causal: bool, window: int = 0,
                       kv_len=None):
    """The reference's training attention on (B, S, H, hd) q, k, v, in
    torch ops that autograd differentiates: ``mha_chunked`` above
    S = 2048 with S % 256 == 0 and no key mask, in blocks of
    ``_chunk(S)`` (``chunked_attention``'s CPU rule), else
    ``mha_einsum`` (with ``kv_len`` as its prefix key mask)."""
    S = q.shape[1]
    if S > 2048 and S % 256 == 0 and kv_len is None:
        chunk = _chunk(S)
        return mha_chunked(q, k, v, causal=causal, window=window,
                           q_chunk=chunk, kv_chunk=chunk)
    kv_valid = None
    if kv_len is not None:
        kv_valid = (torch.arange(k.shape[1], device=q.device)[None, :]
                    < kv_len.to(q.device)[:, None])
    return mha_einsum(q, k, v, causal=causal, window=window,
                      kv_valid=kv_valid)


def cross_attention(q, k, v):
    """Non-causal attention of (B, Sq, Hq, hd) decoder queries over
    (B, Sk, Hkv, hd) encoder keys and values, as the reference's
    ``attn_forward`` computes it with ``kv_override``: ``mha_chunked``
    (q, k, v, P rounded to bf16) above Sq = 2048 with Sq % 256 == 0,
    else ``mha_einsum``; torch ops on every device, differentiable."""
    Sq, Sk = q.shape[1], k.shape[1]
    if Sq > 2048 and Sq % 256 == 0:
        return mha_chunked(q, k, v, causal=False, q_chunk=_chunk(Sq),
                           kv_chunk=_chunk(Sk))
    return mha_einsum(q, k, v, causal=False)


def attn_forward(p, x, cfg, *, positions, causal=True, window=0,
                 head_gate=None, kv_len=None, training=False,
                 kv_override=None):
    """Full-sequence attention (train / prefill / encoder; with
    ``kv_override`` a cross-attention).

    kv_len: optional (B,) int32 count of each row's valid keys for
    right-padded ragged batches — keys past it contribute nothing to
    any query (the reference's prefix ``kv_valid`` mask).  Without it,
    above S = 2048 (S % 256 == 0) the attention is the reference's
    ``mha_chunked`` (``chunked_attention``).
    head_gate: AdaSplit structured mask, (H,) or (B, H), gating each
    head's output before the wo projection.
    training: the reference's differentiable training attention
    (``training_attention``) in place of the flash kernel.
    kv_override: (k, v) already projected (``cross_kv``): a
    cross-attention, its queries without RoPE, non-causal, unwindowed,
    through ``cross_attention`` (never the flash kernel).
    Returns (out, (k, v)) so prefill can stash the cache."""
    if kv_override is not None:
        k, v = kv_override
        out = cross_attention(_project(p, x, cfg, x.dtype, "q")[0], k, v)
    else:
        out, (k, v) = _self_attention(p, x, cfg, positions, causal, window,
                                      kv_len, training)
    return _project_out(p, out, head_gate, x.dtype), (k, v)


def _self_attention(p, x, cfg, positions, causal, window, kv_len, training):
    """``attn_forward``'s self-attention before the head gate: returns
    (out (B, S, Hq, hd), (k, v))."""
    S = x.shape[1]
    q, k, v = _project(p, x, cfg, x.dtype)
    q, k = _rope_qk(q, k, cfg, positions)
    if training:
        out = training_attention(q, k, v, causal=causal, window=window,
                                 kv_len=kv_len)
    elif S > 2048 and S % 256 == 0 and kv_len is None:
        # where the reference's attn_forward takes mha_chunked
        out = chunked_attention(q, k, v, causal=causal, window=window)
    else:
        out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=causal,
                              window=window, kv_len=kv_len).transpose(1, 2)
    return out, (k, v)


def init_kv_cache(cfg, batch, length, dtype, device="cuda"):
    shape = (batch, length, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attn_decode(p, x, cache, pos, cfg, *, window=0, head_gate=None,
                kv_override=None):
    """One-token decode.  x: (B, 1, D).

    pos is a scalar (an int or a 0-d tensor: the whole batch at one
    position) or a (B,) int tensor of PER-SLOT positions: each row
    writes its K/V at its own cache slot and attends only keys at
    ``idx <= pos[b]``; under M-RoPE it is the position of all three
    streams.  With ``window`` the cache is a ring buffer of that
    length.  The cache is updated IN PLACE (the reference returns a new
    one; here the old one is not needed again and a copy per step would
    double the cache traffic); returns (out, cache).

    kv_override: a cross-attention's (k, v) over the encoder states
    (the cache's ``cross_k``/``cross_v``): ``attn_forward``'s cross
    branch, the query attending all of them; no cache is written and
    ``cache`` comes back as given."""
    dtype = x.dtype
    B = x.shape[0]
    if kv_override is not None:
        return attn_forward(p, x, cfg, positions=None, head_gate=head_gate,
                            kv_override=kv_override)[0], cache
    q, k, v = _project(p, x, cfg, dtype)
    per_slot = torch.is_tensor(pos) and pos.ndim == 1
    if per_slot:
        posv = pos.to(device=x.device, dtype=torch.long)
        posb = posv[:, None]
    else:
        pos = int(pos)
        posb = torch.full((B, 1), pos, dtype=torch.long, device=x.device)
    if cfg.mrope_sections:               # one position on all three streams
        posb = posb[..., None].expand(B, 1, 3)
    q, k = _rope_qk(q, k, cfg, posb)
    k_all, v_all = cache["k"], cache["v"]
    L = k_all.shape[1]
    idx = torch.arange(L, device=x.device)
    if per_slot:
        slot = posv % L if window else posv.clamp(max=L - 1)
        bidx = torch.arange(B, device=x.device)
        k_all[bidx, slot] = k[:, 0].to(k_all.dtype)
        v_all[bidx, slot] = v[:, 0].to(v_all.dtype)
        if window:
            kv_valid = idx[None, :] < torch.clamp(posv + 1, max=L)[:, None]
        else:
            kv_valid = idx[None, :] <= posv[:, None]
    else:
        slot = pos % L if window else min(pos, L - 1)
        k_all[:, slot] = k[:, 0].to(k_all.dtype)
        v_all[:, slot] = v[:, 0].to(v_all.dtype)
        n_valid = min(pos + 1, L) if window else pos + 1
        kv_valid = (idx < n_valid)[None, :].expand(B, L)
    out = mha_einsum(q, k_all, v_all, causal=False, kv_valid=kv_valid)
    return _project_out(p, out, head_gate, dtype), cache


def cross_kv(p, enc_out, cfg, dtype):
    """Project encoder states (B, S, D) once into a cross-attention's K/V,
    (B, S, Hkv, hd) each."""
    return tuple(_project(p, enc_out, cfg, dtype, "kv"))
