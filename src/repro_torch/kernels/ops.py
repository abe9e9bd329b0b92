"""The port's public kernel API, port of ``repro.kernels.ops``.

The reference's names and arguments; each op delegates to the port's
kernel module, which launches the hand-written CUDA kernel for CUDA
tensors and runs its plain PyTorch version for CPU tensors.  The TPU
tiling knobs of the reference (``block_q``, ``block_k``, a GEMM
``method``) have no counterpart: the CUDA kernels pick their own tiles.
"""
from __future__ import annotations

from repro_torch.kernels import client_conv as _cc
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import masked_adam as _ma
from repro_torch.kernels import ntxent as _nt
from repro_torch.kernels import soft_threshold as _st


def ntxent_loss(q, labels, tau: float = 0.07, normalize: bool = True):
    """Supervised NT-Xent over q (..., B, D), labels (..., B): the mean
    over positive pairs per leading index."""
    return _nt.ntxent_loss(q, labels, tau, normalize=normalize)


def flash_attention(q, k, v, causal: bool = True, window: int = 0):
    """q (B, Hq, S, hd); k, v (B, Hkv, S, hd)."""
    return _fa.flash_attention(q, k, v, causal=causal, window=window)


def soft_threshold(x, threshold: float):
    return _st.soft_threshold(x, threshold)


def client_conv(x, w):
    """Stacked-client "same" conv as one batched GEMM: x (C, B, H, W,
    Cin), w (C, K, K, Cin, Cout) (client axis optional on both)."""
    return _cc.client_conv(x, w)


def masked_adam(p, g, mu, nu, mask, step, lr: float = 1e-3,
                b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    """One fused masked Adam step on one leaf -> (p, mu, nu)."""
    return _ma.masked_adam(p, g, mu, nu, mask, lr=lr, b1=b1, b2=b2, eps=eps,
                           step=step)
