"""Fused masked-Adam update (AdaSplit eq. 7): one pass per leaf.

Port of ``repro.kernels.masked_adam``.  For CUDA tensors each leaf runs
the hand-written kernel ``csrc/masked_adam.cu``; for CPU tensors the
plain PyTorch version below, which does the same float32 arithmetic in
the same order.  The bias corrections ``1 - beta^t`` are per ROW of a
stacked leaf and stay on the device: ``step`` may be a scalar or a
``(S,)`` vector whose row ``s`` is the step of the leaf's row ``s`` (the
per-client step vectors of the mask-Adam state).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.weights import tree_leaves, tree_unflatten

LAUNCHES = {"masked_adam": 0}


def reset_launches():
    LAUNCHES["masked_adam"] = 0


def bias_corrections(step, b1, b2):
    """Per-row (1 - b1^t, 1 - b2^t) as float32 tensors on step's device."""
    stepf = torch.as_tensor(step).to(torch.float32)
    return 1.0 - torch.pow(b1, stepf), 1.0 - torch.pow(b2, stepf)


def _rows(t, b1t):
    """b1t (S,) reshaped to broadcast over a (S, ...) leaf; a scalar
    stays a scalar."""
    return b1t.reshape(b1t.shape + (1,) * (t.ndim - b1t.ndim))


def masked_adam_plain(p, g, mu, nu, mask, *, lr, b1, b2, eps, b1t, b2t):
    """Plain PyTorch version of the kernel's arithmetic."""
    g = g.to(torch.float32)
    if mask is not None:
        g = g * mask.to(torch.float32)
    mu = b1 * mu + (1 - b1) * g
    nu = b2 * nu + (1 - b2) * g * g
    mhat = mu / _rows(mu, b1t)
    nhat = nu / _rows(nu, b2t)
    new_p = p.to(torch.float32) - lr * mhat / (torch.sqrt(nhat) + eps)
    return new_p.to(p.dtype), mu, nu


def _lib():
    lib = _build.load("masked_adam")
    if not getattr(lib, "_typed", False):
        p, ll, f = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float
        lib.masked_adam_f32.argtypes = [p, p, p, p, p, p, p, p, p, p, ll, ll,
                                        f, f, f, f, f, f, ctypes.c_int, p]
        lib.masked_adam_f32.restype = ctypes.c_int
        lib._typed = True
    return lib


def masked_adam_cuda(p, g, mu, nu, mask, *, lr, b1, b2, eps, b1t, b2t):
    """Launch ``csrc/masked_adam.cu`` on one leaf.  All operands float32,
    contiguous, same shape, on one CUDA device; b1t/b2t hold one value
    per row of the leading axis (or one value in all)."""
    ops = {"p": p, "g": g, "mu": mu, "nu": nu, "b1t": b1t, "b2t": b2t}
    if mask is not None:
        ops["mask"] = mask
    for name, t in ops.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: float32 required, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: contiguous tensor required")
        if t.device != p.device or p.device.type != "cuda":
            raise ValueError(f"{name}: all operands on one CUDA device")
        if name in ("g", "mu", "nu", "mask") and t.shape != p.shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)} != "
                             f"{tuple(p.shape)}")
    n = p.numel()
    rows = b1t.numel()
    if b2t.numel() != rows or (rows > 1 and (p.ndim == 0
                                             or p.shape[0] != rows)):
        raise ValueError(f"{rows} step rows for a leaf of {tuple(p.shape)}")
    outs = [torch.empty_like(p) for _ in range(3)]
    if n == 0:
        return tuple(outs)
    lib = _lib()
    with torch.cuda.device(p.device):
        err = lib.masked_adam_f32(
            p.data_ptr(), g.data_ptr(), mu.data_ptr(), nu.data_ptr(),
            mask.data_ptr() if mask is not None else None,
            b1t.data_ptr(), b2t.data_ptr(),
            outs[0].data_ptr(), outs[1].data_ptr(), outs[2].data_ptr(),
            n, n // rows, lr, b1, b2, 1 - b1, 1 - b2, eps,
            _build.sm_count(p.device),
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "masked_adam_f32")
    LAUNCHES["masked_adam"] += 1
    return tuple(outs)


def _leaf(p, g, mu, nu, mask, **kw):
    """The kernel for a CUDA leaf, the plain version for a CPU leaf."""
    if p.device.type == "cpu":
        return masked_adam_plain(p, g, mu, nu, mask, **kw)
    return masked_adam_cuda(p, g.contiguous(), mu, nu,
                            None if mask is None else mask.contiguous(), **kw)


def masked_adam(p, g, mu, nu, mask=None, *, lr, b1=0.9, b2=0.999, eps=1e-8,
                step=1):
    """One fused (masked) Adam step on one leaf -> (p, mu, nu).

    ``mask`` may be None (plain fused Adam).  ``step`` is the step AFTER
    this update: an int, a scalar tensor, or an (S,) tensor of per-row
    steps for a stacked (S, ...) leaf."""
    if not torch.is_tensor(step):
        step = torch.tensor(step, dtype=torch.int32, device=p.device)
    b1t, b2t = bias_corrections(step, b1, b2)
    return _leaf(p, g, mu, nu, mask, lr=lr, b1=b1, b2=b2, eps=eps, b1t=b1t,
                 b2t=b2t)


def fused_adam_update(params, grads, state, *, lr, b1=0.9, b2=0.999,
                      eps=1e-8, mask=None):
    """Drop-in ``optim.adam.adam_update`` twin running every leaf through
    the fused kernel.  ``state`` is an ``adam_init`` dict whose ``step``
    is a scalar or a per-row ``(S,)`` vector; ``mask`` an optional tree
    of multiplicative gradient masks.  The bias corrections are computed
    once for all leaves."""
    step = state["step"] + 1
    b1t, b2t = bias_corrections(step, b1, b2)
    flat_p = tree_leaves(params)
    flat_m = tree_leaves(mask) if mask is not None else [None] * len(flat_p)
    out = [_leaf(p, g, mu, nu, m, lr=lr, b1=b1, b2=b2, eps=eps, b1t=b1t,
                 b2t=b2t)
           for p, g, mu, nu, m in zip(
               flat_p, tree_leaves(grads), tree_leaves(state["mu"]),
               tree_leaves(state["nu"]), flat_m)]
    new = [tree_unflatten(params, [o[i] for o in out]) for i in range(3)]
    return new[0], {"mu": new[1], "nu": new[2], "step": step}
