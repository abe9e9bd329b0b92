"""Stacked per-client KxK "same" conv as an im2col panel GEMM.

Port of ``repro.kernels.client_conv``.  The whole stacked conv is ONE
batched GEMM

    (C, B*H*W, K*K*Cin) @ (C, K*K*Cin, Cout)

whose forward runs the hand-written CUDA kernel ``csrc/panel_gemm.cu``
for CUDA tensors (with an optional bias+ReLU epilogue), and its plain
PyTorch version for CPU tensors.  ``plan_panel_gemm`` picks the
kernel's output tile and how many ways it splits K, so that the grid
fills the card.  The backward is ``torch.bmm``, as the
reference routes its custom VJP through einsum GEMMs that it, too,
leaves outside Pallas; the fused epilogue's ReLU mask comes from the
saved output (``out > 0`` <=> pre-activation > 0).

Layouts are the reference's: NHWC activations, HWIO ``(K, K, Cin, Cout)``
filters, stacked with a leading client axis ``(C, K, K, Cin, Cout)``.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

# launches of the CUDA kernel, per variant (never the plain version)
LAUNCHES = {"panel_gemm": 0, "panel_gemm_bias_relu": 0}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# im2col ("same" padding, stride 1, odd K)
# ---------------------------------------------------------------------------


def im2col(x, k: int):
    """(..., H, W, Cin) -> (..., H, W, K*K*Cin) patch tensor: K*K shifted
    HxW slices of the zero-padded input concatenated along channels in
    (ki, kj, cin) row-major order — the order ``w.reshape(K*K*Cin, Cout)``
    flattens the filter, so the conv is exactly ``patches @ panel``."""
    assert k % 2 == 1, k
    h, w = x.shape[-3], x.shape[-2]
    pad = k // 2
    xp = F.pad(x, (0, 0, pad, pad, pad, pad))
    cols = [xp[..., i:i + h, j:j + w, :] for i in range(k) for j in range(k)]
    return torch.cat(cols, dim=-1)


def _panels(x, w):
    """(patches, panels, out_shape): patches (lead..., M, K*K*Cin) with M
    the product of the non-client, non-channel axes; panels (lead...,
    K*K*Cin, Cout)."""
    lead = tuple(w.shape[:-4])
    assert tuple(x.shape[:len(lead)]) == lead, (x.shape, w.shape)
    k, cout = w.shape[-4], w.shape[-1]
    kd = k * k * w.shape[-2]
    patches = im2col(x, k).reshape(lead + (-1, kd))
    panels = w.reshape(lead + (kd, cout))
    return patches, panels, tuple(x.shape[:-1]) + (cout,)


# ---------------------------------------------------------------------------
# the panel GEMM: CUDA kernel and its plain version
# ---------------------------------------------------------------------------


# rows per chunk of the plain version: bounds its (C, rows, K, N) product
_PLAIN_ROWS = 8192

# the kernel's K chunk, its most K splits (the portable cluster size), and
# its output tile's rows for each width of tile (csrc/panel_gemm.cu, Cfg;
# the library is held to this table when it is loaded)
BLOCK_K = 32
MAX_SPLITS = 8
BLOCK_M = {8: 256, 16: 256, 32: 128, 64: 128}
# a split's fixed cost in chunks, in the planner's model (fitted to the
# LeNet server blocks on an H100: 4 splits of K=800 beat 2 of them)
_SPLIT_COST = 2.0


def plan_panel_gemm(C, M, K, N, n_sms):
    """(block_m, block_n, splits) of the kernel for a (C, M, K) @ (C, K,
    N) product on a card of ``n_sms`` SMs.  The tile is the narrowest of
    8/16/32/64 columns that holds N (64 beyond).  A grid that fills the
    card as it is is not split.  Otherwise K is split 2, 4 or 8 ways (the
    splits of one tile run as one thread-block cluster and sum in a fixed
    order), never so far that a split gets fewer than two 32-deep chunks:
    of the counts that give every SM a CTA (the deepest allowed, if none
    does) the one whose busiest SM finishes first, counting a split's
    chunks plus ``_SPLIT_COST`` chunks for its pipeline fill and its
    share of the reduction."""
    block_n = next((bn for bn in (8, 16, 32, 64) if N <= bn), 64)
    block_m = BLOCK_M[block_n]
    tiles = -(-M // block_m) * -(-N // block_n) * C
    chunks = -(-K // BLOCK_K)
    allowed = [s for s in (2, 4, 8) if chunks >= 2 * s]
    if tiles >= n_sms or not allowed:
        return block_m, block_n, 1
    filling = [s for s in allowed if tiles * s >= n_sms] or allowed[-1:]

    def busiest(s):
        return -(-tiles * s // n_sms) * (chunks / s + _SPLIT_COST)
    return block_m, block_n, min(filling, key=busiest)


def panel_gemm_plain(a, b, bias=None):
    """Plain PyTorch version of the kernel: each output is the float32
    sum over K of a[c, m, k] * b[c, k, n] (+ bias, ReLU), taken in row
    chunks of ``_PLAIN_ROWS``."""
    outs = []
    for m0 in range(0, a.shape[1], _PLAIN_ROWS):
        blk = a[:, m0:m0 + _PLAIN_ROWS, :, None] * b[:, None, :, :]
        outs.append(blk.sum(dim=2))
    out = torch.cat(outs, dim=1) if outs else a.new_zeros(
        (a.shape[0], 0, b.shape[2]))
    if bias is not None:
        out = torch.relu(out + bias[:, None, :])
    return out


def _check(t, name, ndim):
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: float32 required, got {t.dtype}")
    if t.ndim != ndim:
        raise ValueError(f"{name}: {ndim}-D required, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: contiguous tensor required")


def panel_gemm_cuda(a, b, bias=None):
    """Launch ``csrc/panel_gemm.cu``: a (C, M, K) @ b (C, K, N) [+ bias
    (C, N), ReLU] -> (C, M, N), all float32 CUDA tensors on one device,
    with ``plan_panel_gemm``'s tile and K splits for the device."""
    _check(a, "a", 3)
    _check(b, "b", 3)
    C, M, K = a.shape
    if b.shape[0] != C or b.shape[1] != K:
        raise ValueError(f"shape mismatch {tuple(a.shape)} @ {tuple(b.shape)}")
    N = b.shape[2]
    devs = {a.device, b.device}
    if bias is not None:
        _check(bias, "bias", 2)
        if tuple(bias.shape) != (C, N):
            raise ValueError(f"bias must be {(C, N)}, got {tuple(bias.shape)}")
        devs.add(bias.device)
    if len(devs) != 1 or a.device.type != "cuda":
        raise ValueError(f"tensors must share one CUDA device, got {devs}")
    out = torch.empty((C, M, N), device=a.device, dtype=torch.float32)
    if out.numel() == 0:
        return out
    _, block_n, splits = plan_panel_gemm(C, M, K, N,
                                         _build.sm_count(a.device))
    lib = _lib()
    with torch.cuda.device(a.device):
        err = lib.panel_gemm_f32(
            a.data_ptr(), b.data_ptr(),
            bias.data_ptr() if bias is not None else None, out.data_ptr(),
            C, M, K, N, block_n, splits,
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "panel_gemm_f32")
    LAUNCHES["panel_gemm" if bias is None else "panel_gemm_bias_relu"] += 1
    return out


def _lib():
    lib = _build.load("panel_gemm")
    if not getattr(lib, "_typed", False):
        p = ctypes.c_void_p
        i = ctypes.c_int
        lib.panel_gemm_f32.argtypes = [p, p, p, p, i, i, i, i, i, i, p]
        lib.panel_gemm_f32.restype = ctypes.c_int
        lib.panel_gemm_block_m.argtypes = [i]
        lib.panel_gemm_block_m.restype = i
        built = {bn: lib.panel_gemm_block_m(bn) for bn in BLOCK_M}
        if built != BLOCK_M:
            raise RuntimeError(f"panel_gemm.cu tiles {built} differ from "
                               f"the planner's BLOCK_M {BLOCK_M}")
        lib._typed = True
    return lib


def _forward(a, b, bias=None):
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if a.device.type == "cpu":
        return panel_gemm_plain(a, b, bias)
    return panel_gemm_cuda(a, b, bias)


class _PanelGemm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _forward(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        da = torch.bmm(g, b.transpose(1, 2)) if ctx.needs_input_grad[0] \
            else None
        db = torch.bmm(a.transpose(1, 2), g) if ctx.needs_input_grad[1] \
            else None
        return da, db


class _PanelGemmFused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, bias):
        out = _forward(a, b, bias)
        ctx.save_for_backward(a, b, out)
        return out

    @staticmethod
    def backward(ctx, g):
        a, b, out = ctx.saved_tensors
        dz = torch.where(out > 0, g, torch.zeros((), dtype=g.dtype,
                                                 device=g.device))
        da = torch.bmm(dz, b.transpose(1, 2)) if ctx.needs_input_grad[0] \
            else None
        db = torch.bmm(a.transpose(1, 2), dz) if ctx.needs_input_grad[1] \
            else None
        dbias = dz.sum(dim=1) if ctx.needs_input_grad[2] else None
        return da, db, dbias


def panel_gemm(a, b):
    """(C, M, K) @ (C, K, N) through the panel-GEMM kernel, differentiable."""
    return _PanelGemm.apply(a.contiguous(), b.contiguous())


def panel_gemm_fused(a, b, bias):
    """``relu(panel_gemm(a, b) + bias[:, None, :])`` with the epilogue
    in the kernel's writeback, differentiable."""
    return _PanelGemmFused.apply(a.contiguous(), b.contiguous(),
                                 bias.contiguous())


# ---------------------------------------------------------------------------
# public conv entry point
# ---------------------------------------------------------------------------


def broadcast_bias(bias):
    """A conv bias shaped for NHWC broadcast: stacked (C, Cout) ->
    (C, 1, 1, 1, Cout); unstacked (Cout,) unchanged."""
    if bias.ndim > 1:
        return bias.reshape(tuple(bias.shape[:-1]) + (1, 1, 1)
                            + tuple(bias.shape[-1:]))
    return bias


def client_conv(x, w, *, bias=None, fused_epilogue: bool = False):
    """Stacked-client KxK "same" conv, client axis optional.

    x (C, B, H, W, Cin) with w (C, K, K, Cin, Cout), or unstacked
    (..., H, W, Cin) with w (K, K, Cin, Cout).  ``fused_epilogue=True``
    (requires ``bias``: (C, Cout) stacked or (Cout,)) returns
    ``relu(conv + bias)`` with the epilogue in the kernel's writeback.
    """
    assert (bias is not None) == fused_epilogue, (fused_epilogue, bias)
    patches, panels, out_shape = _panels(x, w)
    if w.ndim == 4:                      # unstacked: batch of one panel
        patches, panels = patches[None], panels[None]
        bias = bias[None] if bias is not None else None
    if fused_epilogue:
        out = panel_gemm_fused(patches, panels, bias.to(x.dtype))
    else:
        out = panel_gemm(patches, panels)
    if w.ndim == 4:
        out = out[0]
    return out.reshape(out_shape)


def conv_reference(x, w):
    """The same conv as one library call, ``F.conv2d`` (the reference's
    ``batched_conv=False`` path, ``_conv_reference`` /
    ``lax.conv_general_dilated``): stacked x (C, B, H, W, Cin) with w
    (C, K, K, Cin, Cout) as one grouped conv (``groups=C``), or
    unstacked (..., H, W, Cin) with w (K, K, Cin, Cout).  No kernel of
    this module runs."""
    k, cin, cout = w.shape[-4], w.shape[-2], w.shape[-1]
    h, wd = x.shape[-3], x.shape[-2]
    if w.ndim == 5:
        C, B = x.shape[:2]
        xin = x.permute(1, 0, 4, 2, 3).reshape(B, C * cin, h, wd)
        win = w.permute(0, 4, 3, 1, 2).reshape(C * cout, cin, k, k)
        y = F.conv2d(xin, win, padding=k // 2, groups=C)
        return y.reshape(B, C, cout, h, wd).permute(1, 0, 3, 4, 2)
    lead = tuple(x.shape[:-3])
    xin = x.reshape((-1, h, wd, cin)).permute(0, 3, 1, 2)
    y = F.conv2d(xin, w.permute(3, 2, 0, 1), padding=k // 2)
    return y.permute(0, 2, 3, 1).reshape(lead + (h, wd, cout))


# ---------------------------------------------------------------------------
# stacked projection head
# ---------------------------------------------------------------------------


def client_proj(proj, h):
    """Client-axis-aware 2-layer projection head: h (..., M, D) with
    leaves (..., D, H') / (..., H') of the same leading client axes; one
    batched GEMM per layer (``torch.matmul``, as the reference's
    ``jnp.matmul``, in the promoted dtype of its operands: float32
    features through bf16 weights are a float32 product)."""
    def bias(b):
        return b.reshape(tuple(b.shape[:-1]) + (1,) + tuple(b.shape[-1:]))

    def mm(a, w):
        dt = torch.promote_types(a.dtype, w.dtype)
        return torch.matmul(a.to(dt), w.to(dt))
    z = torch.relu(mm(h, proj["w1"]) + bias(proj["b1"]))
    return mm(z, proj["w2"])
