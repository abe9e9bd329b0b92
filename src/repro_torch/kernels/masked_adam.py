"""Fused (masked) Adam update (AdaSplit eq. 7): one launch per call.

Port of ``repro.kernels.masked_adam``.  For CUDA tensors every leaf of
one call runs in ONE launch of the hand-written multi-tensor kernel
``csrc/masked_adam.cu`` (more launches only past ``MAX_LEAVES`` leaves);
for CPU tensors each leaf runs the plain PyTorch version below, which
does the same float32 arithmetic in the same order.  The kernel has two
rounding orders, one per plain version: masked Adam's ``lr * mhat /
(sqrt(nhat) + eps)`` (``masked_adam_plain``, the server and the masks)
and the client step's ``lr * (mhat / (sqrt(nhat) + eps))``
(``adam_leaf_plain``, ``optim.adam.adam_update``).  The bias
corrections ``1 - beta^t`` are per ROW of a stacked leaf and stay on the
device: ``step`` may be a scalar or a ``(S,)`` vector whose row ``s`` is
the step of the leaf's row ``s`` (the per-client step vectors of the
client and mask-Adam states).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.weights import tree_leaves, tree_unflatten

CHUNK = 1024         # elements per CTA of csrc/masked_adam.cu
MAX_LEAVES = 32      # leaves in one launch's parameter table

# launches of the kernel (never the plain versions), by rounding order
LAUNCHES = {"masked_adam": 0, "client_adam": 0}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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


def adam_leaf_plain(p, g, mu, nu, *, lr, b1, b2, eps, b1t, b2t):
    """Plain PyTorch version of the client order: one leaf of
    ``optim.adam.adam_update`` (no mask).  The float32 ops, in order:
    mu' = b1 mu + (1 - b1) g, nu' = b2 nu + ((1 - b2) g) g,
    delta = (mu' / b1t) / (sqrt(nu' / b2t) + eps), p' = p - lr delta;
    written in place on four fresh buffers (the inputs are not touched),
    which on the CPU saves the page faults of a buffer per op at the
    LM's leaf sizes."""
    g = g.to(torch.float32)
    tmp = torch.mul(g, 1 - b1)
    mu = torch.mul(mu, b1).add_(tmp)
    torch.mul(g, 1 - b2, out=tmp).mul_(g)
    nu = torch.mul(nu, b2).add_(tmp)
    torch.div(nu, _rows(nu, b2t), out=tmp).sqrt_().add_(eps)
    delta = torch.div(mu, _rows(mu, b1t)).div_(tmp)
    new_p = torch.sub(p.to(torch.float32), delta.mul_(lr), out=tmp)
    return new_p.to(p.dtype), mu, nu


def adam_multi_plain(leaves, *, client_order=False, **kw):
    """Plain version of one multi-tensor launch: ``leaves`` a list of
    (p, g, mu, nu, mask) -> a list of (p, mu, nu), each leaf through its
    order's per-leaf plain version."""
    if client_order:
        return [adam_leaf_plain(p, g, mu, nu, **kw)
                for p, g, mu, nu, _ in leaves]
    return [masked_adam_plain(*leaf, **kw) for leaf in leaves]


def plan_launches(sizes, max_leaves=MAX_LEAVES, chunk=CHUNK):
    """Split leaves of ``sizes`` elements into launches: a list of
    (entries, blocks), where entries are (leaf index, first block) and
    blocks the launch's grid.  Each launch takes at most ``max_leaves``
    leaves and ceil(n / chunk) blocks per leaf; empty leaves are left
    out (they launch nothing)."""
    launches, entries, blocks = [], [], 0
    for i, n in enumerate(sizes):
        if n == 0:
            continue
        if len(entries) == max_leaves:
            launches.append((entries, blocks))
            entries, blocks = [], 0
        entries.append((i, blocks))
        blocks += -(-n // chunk)
    if entries:
        launches.append((entries, blocks))
    return launches


def _lib():
    lib = _build.load("masked_adam")
    if not getattr(lib, "_typed", False):
        p, ll, f = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float
        lib.adam_multi_f32.argtypes = [p, ctypes.c_int, ll, p, p, f, f, f, f,
                                       f, f, ctypes.c_int, p]
        lib.adam_multi_f32.restype = ctypes.c_int
        lib.adam_chunk.restype = ll
        lib.adam_max_leaves.restype = ctypes.c_int
        if (lib.adam_chunk(), lib.adam_max_leaves()) != (CHUNK, MAX_LEAVES):
            raise RuntimeError("csrc/masked_adam.cu and its wrapper disagree "
                               "on CHUNK or MAX_LEAVES")
        lib._typed = True
    return lib


def _check_leaf(p, g, mu, nu, mask, rows, dev):
    for name, t in (("p", p), ("g", g), ("mu", mu), ("nu", nu),
                    ("mask", mask)):
        if t is None:
            continue
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: float32 required, got {t.dtype}")
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"{name}: all operands on one CUDA device, got "
                             f"{t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: contiguous tensor required")
        if t.shape != p.shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)} != "
                             f"{tuple(p.shape)}")
    if rows > 1 and (p.ndim == 0 or p.shape[0] != rows):
        raise ValueError(f"{rows} step rows for a leaf of {tuple(p.shape)}")


def adam_multi_cuda(leaves, *, lr, b1, b2, eps, b1t, b2t,
                    client_order=False):
    """Launch ``csrc/masked_adam.cu`` once over ``leaves``, a list of
    (p, g, mu, nu, mask or None), all float32, contiguous and on one CUDA
    device; b1t/b2t hold one value per row of every leaf's leading axis
    (or one value in all).  Returns a list of new (p, mu, nu)."""
    dev = b1t.device
    rows = b1t.numel()
    for t in (b1t, b2t):
        if t.dtype != torch.float32 or dev.type != "cuda" \
                or t.device != dev or not t.is_contiguous():
            raise ValueError("b1t, b2t: contiguous float32 on one CUDA "
                             "device required")
    if b2t.numel() != rows:
        raise ValueError(f"b1t has {rows} rows, b2t {b2t.numel()}")
    outs = []
    for p, g, mu, nu, mask in leaves:
        _check_leaf(p, g, mu, nu, mask, rows, dev)
        outs.append((torch.empty_like(p), torch.empty_like(p),
                     torch.empty_like(p)))
    plans = plan_launches([p.numel() for p, *_ in leaves])
    if not plans:
        return outs
    lib = _lib()
    key = "client_adam" if client_order else "masked_adam"
    stream = torch.cuda.current_stream(dev).cuda_stream
    for entries, blocks in plans:
        words = []
        for i, first in entries:
            p, g, mu, nu, mask = leaves[i]
            n = p.numel()
            words += [p.data_ptr(), g.data_ptr(), mu.data_ptr(),
                      nu.data_ptr(), 0 if mask is None else mask.data_ptr(),
                      *(o.data_ptr() for o in outs[i]), n, n // rows, first]
        table = (ctypes.c_longlong * len(words))(*words)
        with torch.cuda.device(dev):
            err = lib.adam_multi_f32(
                table, len(entries), blocks, b1t.data_ptr(), b2t.data_ptr(),
                lr, b1, b2, 1 - b1, 1 - b2, eps, int(client_order), stream)
        _build.check(err, "adam_multi_f32")
        LAUNCHES[key] += 1
    return outs


def adam_multi(leaves, *, lr, b1, b2, eps, b1t, b2t, client_order=False):
    """The per-leaf plain versions when every leaf lies on the CPU, else
    the kernel (one launch), which refuses leaves off one CUDA device;
    ``leaves`` as for :func:`adam_multi_cuda`, but p, g and mask may be of
    any float dtype and every operand of any strides (mu and nu are
    float32, as ``adam_init`` makes them): the kernel takes float32
    contiguous copies where they differ, and each new p goes back to its
    leaf's dtype, as the plain versions' ``.to(p.dtype)`` does."""
    kw = dict(lr=lr, b1=b1, b2=b2, eps=eps, b1t=b1t, b2t=b2t)
    if all(leaf[0].device.type == "cpu" for leaf in leaves):
        return adam_multi_plain(leaves, client_order=client_order, **kw)
    f32 = lambda t: None if t is None else t.to(torch.float32).contiguous()
    outs = adam_multi_cuda([(f32(p), f32(g), mu.contiguous(), nu.contiguous(),
                             f32(m)) for p, g, mu, nu, m in leaves],
                           client_order=client_order, **kw)
    return [(o[0].to(leaf[0].dtype), o[1], o[2])
            for leaf, o in zip(leaves, outs)]


def masked_adam_cuda(p, g, mu, nu, mask, *, lr, b1, b2, eps, b1t, b2t):
    """One leaf through ``csrc/masked_adam.cu`` (a one-leaf launch).  All
    operands float32, contiguous, same shape, on one CUDA device; b1t/b2t
    hold one value per row of the leading axis (or one value in all)."""
    if p.device.type != "cuda":
        raise ValueError(f"p: all operands on one CUDA device, got "
                         f"{p.device}")
    return tuple(adam_multi_cuda([(p, g, mu, nu, mask)], lr=lr, b1=b1, b2=b2,
                                 eps=eps, b1t=b1t, b2t=b2t)[0])


def masked_adam(p, g, mu, nu, mask=None, *, lr, b1=0.9, b2=0.999, eps=1e-8,
                step=1):
    """One fused (masked) Adam step on one leaf -> (p, mu, nu).

    ``mask`` may be None (plain fused Adam).  ``step`` is the step AFTER
    this update: an int, a scalar tensor, or an (S,) tensor of per-row
    steps for a stacked (S, ...) leaf."""
    if not torch.is_tensor(step):
        step = torch.tensor(step, dtype=torch.int32, device=p.device)
    b1t, b2t = bias_corrections(step, b1, b2)
    return tuple(adam_multi([(p, g, mu, nu, mask)], lr=lr, b1=b1, b2=b2,
                            eps=eps, b1t=b1t, b2t=b2t)[0])


def fused_adam_update(params, grads, state, *, lr, b1=0.9, b2=0.999,
                      eps=1e-8, mask=None):
    """Drop-in ``optim.adam.adam_update`` twin running every leaf through
    the fused kernel, one launch for the call.  ``state`` is an
    ``adam_init`` dict whose ``step`` is a scalar or a per-row ``(S,)``
    vector; ``mask`` an optional tree of multiplicative gradient masks.
    The bias corrections are computed once for all leaves."""
    step = state["step"] + 1
    b1t, b2t = bias_corrections(step, b1, b2)
    flat_p = tree_leaves(params)
    flat_m = tree_leaves(mask) if mask is not None else [None] * len(flat_p)
    out = adam_multi(list(zip(flat_p, tree_leaves(grads),
                              tree_leaves(state["mu"]),
                              tree_leaves(state["nu"]), flat_m)),
                     lr=lr, b1=b1, b2=b2, eps=eps, b1t=b1t, b2t=b2t)
    new = [tree_unflatten(params, [o[i] for o in out]) for i in range(3)]
    return new[0], {"mu": new[1], "nu": new[2], "step": step}
