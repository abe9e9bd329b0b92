"""Mamba2 block: the SSD (state-space duality) chunked algorithm and the
one-token recurrence.  Port of ``repro.models.ssm``.

The reference (arXiv:2405.21060 listing 1) carries the (B, H, P, N)
state from chunk to chunk under a ``lax.scan`` and computes each
chunk's intra-chunk term, its state contribution and its output from
the entering state inside the scan body.  Only the state carry is
sequential, so the port computes the intra-chunk terms and the chunk
states of all chunks at once (pairwise products, never the reference's
four-operand intermediate), then the carry (``_carry``) a block of up
to ``CARRY_BLOCK`` chunks at a time, each block's entering states as
one decay-weighted product (the listing's inter-chunk step within the
block), and the entering states' outputs at once after it: the same
terms in other summation orders.  A prompt whose length halves the
chunk down to 1 (an odd length) so costs a dozen launches a block of
64 tokens, where a scan step a chunk would cost a dozen a token.

The chunk rule is the reference's (``min(ssm_chunk, L)``, halved until
it divides L): it decides which terms go through the intra-chunk
product and which through the carried state, so it sets the rounding.
The reference's float32 points are kept: ``x * dt``, ``dt * A``, B and
C in the scan, ``y + x * D``, ``softplus(dt_raw + dt_bias)`` and the
gated RMSNorm (eps 1e-6); results are cast back to the compute dtype
where the reference casts them.

There is no Pallas kernel here in the reference (einsums under a
scan), so there is none here either: the scan is torch ops, and the
projections ``torch.matmul``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.layers import _normal, dense_init


# chunks whose carried states one ``_carry`` step computes at once: its
# decay matrix is (B, H, 64, 64) float32
CARRY_BLOCK = 64


def _conv_dim(cfg) -> int:
    return cfg.d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state


def mamba_init(gen, cfg, lead=(), cast=None):
    """One mamba layer's params with the ``lead`` axes in front, drawn
    from ``gen`` on its device; ``cast``, where given, applied to each
    drawn weight at once (as ``layers.dense_init`` applies it)."""
    d, din = cfg.d_model, cfg.d_inner
    G, N, H = cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_nheads
    lead, dev = tuple(lead), gen.device
    proj_out = 2 * din + 2 * G * N + H  # z, xBC, dt
    conv_w = _normal(gen, lead + (_conv_dim(cfg), cfg.ssm_conv_kernel)) \
        .mul_(0.1)
    full = lambda shape, v: torch.full(lead + shape, v, device=dev)
    return {
        "in_proj": dense_init(gen, d, proj_out, lead=lead, cast=cast),
        "conv_w": conv_w if cast is None else cast(conv_w),
        "conv_b": full((_conv_dim(cfg),), 0.0),
        "A_log": torch.log(torch.arange(1, H + 1, dtype=torch.float32,
                                        device=dev)).expand(lead + (H,))
        .contiguous(),
        "D": full((H,), 1.0),
        "dt_bias": full((H,), 0.0),
        "norm_scale": full((din,), 1.0),
        "out_proj": dense_init(gen, din, d, lead=lead, cast=cast),
    }


def _causal_conv(x, w, b):
    """Depthwise causal conv.  x: (B, L, C); w: (C, K); the K taps
    summed in the reference's order."""
    K, L = w.shape[1], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = xp[:, 0:L, :] * w[:, 0]
    for i in range(1, K):
        out = out + xp[:, i:i + L, :] * w[:, i]
    return out + b


def _segsum(a):
    """a: (..., L) -> (..., L, L) with [i, j] = sum_{j<k<=i} a_k and -inf
    above the diagonal, masked BEFORE any exp (so a backward pass
    through ``exp`` sees 0, never inf * 0)."""
    L = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    above = torch.ones((L, L), dtype=torch.bool, device=a.device).triu(1)
    return seg.masked_fill(above, -math.inf)


def _repeat_groups(t, rep: int, dim: int):
    """``t.repeat_interleave(rep, dim)`` (each group's heads adjacent, as
    ``jnp.repeat``), as a view where there is one group (mamba2's and
    jamba's ``ssm_ngroups``)."""
    shape = t.shape[:dim + 1] + (rep,) + t.shape[dim + 1:]
    return t.unsqueeze(dim + 1).expand(shape).flatten(dim, dim + 1)


def chunk_size(cfg, L: int) -> int:
    """The reference's chunk rule: ``min(ssm_chunk, L)``, halved until it
    divides L."""
    chunk = min(cfg.ssm_chunk, L)
    while L % chunk:
        chunk //= 2
    return chunk


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int, initial_state=None):
    """Chunked SSD scan.

    x:  (B, L, H, P)     inputs (pre-dt)
    dt: (B, L, H)        discretisation steps (post-softplus), float32
    A:  (H,)             negative decay rates
    Bm, Cm: (B, L, G, N) input / output projections (groups repeated
    over the heads, each group's heads adjacent, as ``jnp.repeat``).
    Returns (y, final_state): y (B, L, H, P) and the state (B, H, P, N),
    both float32."""
    Bb, L, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if L % chunk:
        raise ValueError(f"chunk {chunk} does not divide L={L}")
    nc = L // chunk
    rep = H // G
    f32 = torch.float32

    xdt = (x * dt[..., None]).to(f32)                       # (B, L, H, P)
    a = (dt * A).to(f32)                                     # (B, L, H) <= 0
    Bg = _repeat_groups(Bm, rep, 2).to(f32)                   # (B, L, H, N)
    Cg = _repeat_groups(Cm, rep, 2).to(f32)

    # chunked views (B, nc, chunk, ...), the chunk's heads first where a
    # product runs over its positions
    xc = xdt.reshape(Bb, nc, chunk, H, P).permute(0, 1, 3, 2, 4)  # bchlp
    Bc = Bg.reshape(Bb, nc, chunk, H, N).permute(0, 1, 3, 2, 4)   # bchln
    Cc = Cg.reshape(Bb, nc, chunk, H, N).permute(0, 1, 3, 2, 4)   # bchln
    a_t = a.reshape(Bb, nc, chunk, H).permute(0, 1, 3, 2)         # bchl
    a_cum = torch.cumsum(a_t, dim=-1)                              # inclusive

    # intra-chunk: (C B^T * L) x, pairwise
    Lmat = torch.exp(_segsum(a_t))                               # bchls
    y = torch.matmul(torch.matmul(Cc, Bc.transpose(-1, -2)) * Lmat, xc)
    # each chunk's own state contribution: (B * decay)^T x -> (b,c,h,p,n)
    decay_states = torch.exp(a_cum[..., -1:] - a_cum)             # bchl
    chunk_states = torch.matmul(xc.transpose(-1, -2),
                                Bc * decay_states[..., None])     # bchpn

    state = torch.zeros((Bb, H, P, N), dtype=f32, device=x.device) \
        if initial_state is None else initial_state.to(f32)
    entering, state = _carry(chunk_states, a_cum[..., -1], state)

    # the entering state's output: (C state^T) * exp(a_cum)
    y = y + torch.matmul(Cc, entering.transpose(-1, -2)) \
        * torch.exp(a_cum)[..., None]
    y = y.permute(0, 1, 3, 2, 4).reshape(Bb, L, H, P)
    return y, state


def _carry(chunk_states, a_last, state, block: int = CARRY_BLOCK):
    """The state entering each chunk, and the state after the last.

    chunk_states: (B, nc, H, P, N) each chunk's own contribution;
    a_last: (B, nc, H) each chunk's log decay (its summed ``dt * A``,
    <= 0); state: (B, H, P, N) the state entering the first chunk.
    The reference's recurrence ``state = state * exp(a_last[c]) +
    chunk_states[c]``, taken ``block`` chunks at a time: within a
    block, chunk i enters with ``exp(sum_{k<i} a_k) * state +
    sum_{j<i} exp(sum_{j<k<i} a_k) * chunk_states[j]``, the second term
    one (block, block) decay matrix product, masked before its ``exp``.
    Returns (entering (B, nc, H, P, N), final state (B, H, P, N))."""
    Bb, nc, H, P, N = chunk_states.shape
    if nc == 1:
        return state[:, None], state * torch.exp(a_last[:, 0])[..., None,
                                                                None] \
            + chunk_states[:, 0]
    s = chunk_states.permute(0, 2, 1, 3, 4).reshape(Bb, H, nc, P * N)
    la = a_last.transpose(1, 2)                                   # (B, H, nc)
    entering = []
    for c0 in range(0, nc, block):
        a = la[..., c0:c0 + block]
        n = a.shape[-1]
        cs = torch.cumsum(a, dim=-1)                              # inclusive
        excl = cs - a                                             # exclusive
        on_or_above = torch.ones((n, n), dtype=torch.bool,
                                 device=a.device).triu()
        w = torch.exp((excl[..., :, None] - cs[..., None, :])
                      .masked_fill(on_or_above, -math.inf))       # (B,H,n,n)
        sb = s[:, :, c0:c0 + n]                                   # (B,H,n,PN)
        entering.append(torch.matmul(w, sb) + torch.exp(excl)[..., None]
                        * state.reshape(Bb, H, 1, P * N))
        state = state * torch.exp(cs[..., -1])[..., None, None] \
            + torch.matmul(torch.exp(cs[..., -1:] - cs)[..., None, :],
                           sb).reshape(Bb, H, P, N)
    entering = torch.cat(entering, dim=2).reshape(Bb, H, nc, P, N)
    return entering.permute(0, 2, 1, 3, 4), state


def _gated_norm(p, y, z, unit_gate, dtype):
    """The gated RMSNorm (float32 inside, eps 1e-6), then the unit gate
    and the output projection."""
    g = y * F.silu(z)
    gf = g.to(torch.float32)
    g = (gf * torch.rsqrt(torch.mean(gf * gf, dim=-1, keepdim=True) + 1e-6)
         * p["norm_scale"]).to(dtype)
    if unit_gate is not None:
        g = g * unit_gate.to(dtype)
    return g @ p["out_proj"].to(dtype)


def mamba_forward(p, x, cfg, unit_gate: Optional[torch.Tensor] = None,
                  return_state: bool = False):
    """Full-sequence forward.  x: (B, L, D).  unit_gate: (d_inner,) or
    (B, 1, d_inner), on the normed inner activations.  return_state:
    also return the decode cache ``{"state": (B, H, P, N) float32,
    "conv": (B, K-1, conv_dim)}`` (the last K-1 raw pre-conv rows)."""
    dtype = x.dtype
    Bb, L, _ = x.shape
    din, G, N, H, P = (cfg.d_inner, cfg.ssm_ngroups, cfg.ssm_state,
                       cfg.ssm_nheads, cfg.ssm_headdim)
    K = cfg.ssm_conv_kernel
    if return_state and L < K - 1:
        # the reference's tail slice wraps to a negative start here and
        # keeps fewer than K-1 rows, which its decode then cannot take
        raise ValueError(f"a prompt of {L} tokens is shorter than the "
                         f"conv window's {K - 1} cached rows")
    chunk = chunk_size(cfg, L)

    zxbcdt = x @ p["in_proj"].to(dtype)
    z, xBC_raw, dt_raw = torch.split(zxbcdt, [din, din + 2 * G * N, H],
                                     dim=-1)
    xBC = F.silu(_causal_conv(xBC_raw, p["conv_w"].to(dtype),
                              p["conv_b"].to(dtype)))
    xs, Bm, Cm = torch.split(xBC, [din, G * N, G * N], dim=-1)
    xs = xs.reshape(Bb, L, H, P)
    Bm = Bm.reshape(Bb, L, G, N)
    Cm = Cm.reshape(Bb, L, G, N)
    dt = F.softplus(dt_raw.to(torch.float32) + p["dt_bias"])
    A = -torch.exp(p["A_log"])

    y, state = ssd_chunked(xs, dt, A, Bm, Cm, chunk)
    y = y + xs.to(torch.float32) * p["D"][:, None]
    y = y.reshape(Bb, L, din).to(dtype)
    out = _gated_norm(p, y, z, unit_gate, dtype)
    if return_state:
        return out, {"state": state, "conv": xBC_raw[:, L - (K - 1):, :]}
    return out


def init_ssm_cache(cfg, batch, dtype, device="cuda"):
    H, P, N = cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state
    K = cfg.ssm_conv_kernel
    return {"state": torch.zeros((batch, H, P, N), dtype=torch.float32,
                                 device=device),
            "conv": torch.zeros((batch, K - 1, _conv_dim(cfg)), dtype=dtype,
                                device=device)}


def mamba_decode(p, x, cache, cfg, unit_gate: Optional[torch.Tensor] = None):
    """One-token step.  x: (B, 1, D).  The cache is updated IN PLACE (as
    the attention decode's is); returns (out (B, 1, D), cache).
    unit_gate: (d_inner,) or (B, 1, d_inner): the token axis is kept
    through the norm, so a per-example gate meets its own row."""
    dtype = x.dtype
    Bb = x.shape[0]
    din, G, N, H, P = (cfg.d_inner, cfg.ssm_ngroups, cfg.ssm_state,
                       cfg.ssm_nheads, cfg.ssm_headdim)
    f32 = torch.float32
    zxbcdt = x[:, 0] @ p["in_proj"].to(dtype)                    # (B, proj)
    z, xBC, dt_raw = torch.split(zxbcdt, [din, din + 2 * G * N, H], dim=-1)

    # conv ring: window = the cached K-1 raw rows and the new one
    win = torch.cat([cache["conv"], xBC[:, None, :].to(cache["conv"].dtype)],
                    dim=1)                                       # (B, K, C)
    conv_out = torch.einsum("bkc,ck->bc", win.to(f32),
                            p["conv_w"].to(f32)) + p["conv_b"]
    xBC = F.silu(conv_out).to(dtype)

    xs, Bm, Cm = torch.split(xBC, [din, G * N, G * N], dim=-1)
    xs = xs.reshape(Bb, H, P).to(f32)
    Bm = _repeat_groups(Bm.reshape(Bb, G, N), H // G, 1).to(f32)
    Cm = _repeat_groups(Cm.reshape(Bb, G, N), H // G, 1).to(f32)
    dt = F.softplus(dt_raw.to(f32) + p["dt_bias"])               # (B, H)
    A = -torch.exp(p["A_log"])

    decay = torch.exp(dt * A)                                    # (B, H)
    state = cache["state"] * decay[..., None, None] \
        + (dt[..., None] * xs)[..., None] * Bm[:, :, None, :]
    y = torch.einsum("bhpn,bhn->bhp", state, Cm) + xs * p["D"][:, None]
    y = y.reshape(Bb, 1, din).to(dtype)
    out = _gated_norm(p, y, z[:, None], unit_gate, dtype)
    cache["state"].copy_(state)
    cache["conv"].copy_(win[:, 1:])
    return out, cache
