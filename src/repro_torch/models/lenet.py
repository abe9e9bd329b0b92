"""The paper's own backbone: LeNet-style CNN (AdaSplit §4.4) with the
client/server split (port of ``repro.models.lenet``).

Each conv block = 5x5 "same" conv + ReLU + 2x2 VALID maxpool, over NHWC
activations with HWIO filters.  Every conv goes through
``kernels.client_conv`` (the panel-GEMM kernel on the card), or with
``batched_conv=False`` through the library conv ``conv_reference``.
Params are nested dicts of tensors, client axis optional: stacked
``(C, ...)`` leaves take ``(C, B, H, W, Cin)`` inputs and run as one
batched GEMM.
Server unit gates act on conv output channels and FC hidden units; each
gate leaf is ``(U,)`` (one client, shared across the batch), ``(B, U)``
(per example), or stacked ``(C, U)`` against ``(C, B, ...)`` inputs.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.client_conv import (broadcast_bias, client_conv,
                                             conv_reference)


def _conv_init(gen, cin, cout, k=5):
    w = torch.randn((k, k, cin, cout), generator=gen) \
        * math.sqrt(2.0 / (k * k * cin))
    return {"w": w, "b": torch.zeros((cout,))}


def _gate_like(g, y):
    """Align a gate's leading axes with y's, last axis = units."""
    g = g.to(y.dtype)
    return g.reshape(tuple(g.shape[:-1]) + (1,) * (y.ndim - g.ndim)
                     + tuple(g.shape[-1:]))


def maxpool2x2(y):
    """2x2 VALID max pool over (..., H, W, C), the reference's
    ``reduce_window`` semantics: odd edges dropped, and the gradient goes
    to the FIRST maximum of each window in row-major window order
    (``torch.max`` over a dim returns the first maximal index and routes
    the gradient there alone; ``amax`` would split it among ties)."""
    h, w = y.shape[-3] // 2, y.shape[-2] // 2
    c = y.shape[-1]
    lead = tuple(y.shape[:-3])
    y = y[..., :2 * h, :2 * w, :].reshape(lead + (h, 2, w, 2, c))
    n = len(lead)
    y = y.permute(*range(n), n, n + 2, n + 4, n + 1, n + 3)
    return y.reshape(lead + (h, w, c, 4)).max(dim=-1).values


def _conv_block(p, x, gate=None, *, fused_epilogue=False, batched_conv=True):
    """One conv+ReLU+maxpool block, client axis optional.
    ``batched_conv=False`` takes the library conv (``conv_reference``)
    with the bias and ReLU as plain ops, fused epilogue or not, as the
    reference's ``batched_conv=False`` does."""
    w = p["w"].to(x.dtype)
    if not batched_conv:
        y = torch.relu(conv_reference(x, w)
                       + broadcast_bias(p["b"]).to(x.dtype))
    elif fused_epilogue:
        y = client_conv(x, w, bias=p["b"], fused_epilogue=True)
    else:
        y = torch.relu(client_conv(x, w) + broadcast_bias(p["b"]).to(x.dtype))
    if gate is not None:
        y = y * _gate_like(gate, y)
    return maxpool2x2(y)


def split_index(cfg) -> int:
    return max(1, int(round(cfg.mu * len(cfg.conv_channels))))


def init_client_params(cfg, gen: torch.Generator):
    s = split_index(cfg)
    cin = 3
    blocks = []
    for c in cfg.conv_channels[:s]:
        blocks.append(_conv_init(gen, cin, c))
        cin = c
    return {"blocks": blocks}


def init_server_params(cfg, gen: torch.Generator):
    s = split_index(cfg)
    cin = cfg.conv_channels[s - 1]
    blocks = []
    for c in cfg.conv_channels[s:]:
        blocks.append(_conv_init(gen, cin, c))
        cin = c
    spatial = cfg.image_size // (2 ** len(cfg.conv_channels))
    flat = max(spatial, 1) ** 2 * cfg.conv_channels[-1]

    def dense(din, dout, scale):
        return {"w": torch.randn((din, dout), generator=gen) * scale,
                "b": torch.zeros((dout,))}
    return {"blocks": blocks,
            "fc1": dense(flat, 120, math.sqrt(2.0 / flat)),
            "fc2": dense(120, cfg.d_model, math.sqrt(2.0 / 120)),
            "head": dense(cfg.d_model, cfg.n_classes, 0.05)}


def init_params(cfg, gen: torch.Generator):
    """The whole model, client tower and server half, from one generator
    (the federated baselines' model)."""
    return {"client": init_client_params(cfg, gen),
            "server": init_server_params(cfg, gen)}


def client_forward(cfg, p, images, *, fused_epilogue=False,
                   batched_conv=True):
    """Client tower: images (B, H, W, 3) unstacked, or (C, B, H, W, 3)
    with (C, ...)-leading params.  Returns the split activations."""
    x = images.to(torch.float32)
    for bp in p["blocks"]:
        x = _conv_block(bp, x, fused_epilogue=fused_epilogue,
                        batched_conv=batched_conv)
    return x


def server_forward(cfg, p, acts, *, gates=None, fused_epilogue=False,
                   batched_conv=True):
    """Server blocks + FC head -> (float32 logits, 0).  Stacked params
    (per-client effective weights, ``(S, ...)`` leaves) take stacked
    acts ``(S, B, H, W, C)``; gates as in the module docstring."""
    x = acts
    for i, bp in enumerate(p["blocks"]):
        g = gates["blocks"][i] if gates is not None else None
        x = _conv_block(bp, x, gate=g, fused_epilogue=fused_epilogue,
                        batched_conv=batched_conv)
    x = x.reshape(tuple(x.shape[:-3]) + (-1,))

    def fc(pp, x, gate, act=True):
        b = pp["b"].to(x.dtype)
        if b.ndim > 1:                           # stacked: (S, U) -> (S, 1, U)
            b = b[..., None, :]
        y = torch.matmul(x, pp["w"].to(x.dtype)) + b
        if act:
            y = torch.relu(y)
        if gate is not None:
            y = y * _gate_like(gate, y)
        return y

    x = fc(p["fc1"], x, gates["fc1"] if gates is not None else None)
    x = fc(p["fc2"], x, gates["fc2"] if gates is not None else None)
    logits = fc(p["head"], x, None, act=False)
    return logits.to(torch.float32), torch.zeros((), device=logits.device)


def forward(cfg, params, images, **kw):
    """The whole model: client tower, then the server half (``kw`` to
    :func:`server_forward`) -> (float32 logits, 0)."""
    acts = client_forward(cfg, params["client"], images)
    return server_forward(cfg, params["server"], acts, **kw)
