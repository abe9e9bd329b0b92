"""Flash attention forward: causal / sliding-window GQA, online softmax.

Port of ``repro.kernels.flash_attention``.  For CUDA tensors the call
launches the hand-written kernel ``csrc/flash_attention.cu``; for CPU
tensors it runs the plain PyTorch version below, which computes the
same function in float32 as ``models.attention.mha_einsum`` does.  A
CUDA tensor never reaches the plain version through this wrapper.

Layout is the reference kernel's: q ``(B, Hq, S, hd)``, k and v
``(B, Hkv, S, hd)``, query head h reading kv head ``h // (Hq // Hkv)``.
Beyond the reference it takes ``kv_len`` ``(B,)`` int32: keys
``j >= kv_len[b]`` are masked for every query of row b — the serving
path's key-validity mask for right-padded prompts, whose valid keys are
a prefix of each row (``kv_len = last_index + 1``).  S need not divide
any tile size.  A query row that sees no key (only possible with
``kv_len`` and a window) is zeros in both versions.

The kernel has no backward (nor has the reference's): with grad mode on,
a CUDA q, k or v that requires grad is refused, never passed through
with its gradient silently cut.  Training takes the differentiable
attention of ``models.attention.training_attention``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
HEAD_DIMS = (64, 96, 128)    # head dims the CUDA kernel is built for
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# launches of the CUDA kernel (never the plain version)
LAUNCHES = {"flash_attention": 0}


def reset_launches():
    LAUNCHES["flash_attention"] = 0


def flash_attention_plain(q, k, v, *, causal=True, window=0, kv_len=None):
    """Plain PyTorch version: float32 scores, masked with -1e30, softmax
    and the value sum, cast back to q's dtype — ``mha_einsum``'s math in
    the kernel's layout.  A query row that sees no key at all (only
    possible with ``kv_len`` and a window) comes out as
    zeros, as in the kernel; ``mha_einsum``'s softmax over all-masked
    scores would average every key instead."""
    B, Hq, S, hd = q.shape
    G = Hq // k.shape[1]
    kf = k.to(torch.float32).repeat_interleave(G, dim=1)
    vf = v.to(torch.float32).repeat_interleave(G, dim=1)
    scores = q.to(torch.float32) @ kf.transpose(-1, -2) / math.sqrt(hd)
    pos = torch.arange(S, device=q.device)
    seen = torch.ones((1, 1, S, S), dtype=torch.bool, device=q.device)
    if causal:
        seen = seen & (pos[None, :] <= pos[:, None])
    if window:
        seen = seen & (pos[None, :] > pos[:, None] - window)
    if kv_len is not None:
        valid = pos[None, :] < kv_len.to(q.device)[:, None]
        seen = seen & valid[:, None, None, :]
    w = torch.softmax(scores.masked_fill(~seen, NEG_INF), dim=-1)
    if kv_len is not None and window:
        w = w * seen.any(dim=-1, keepdim=True)
    return (w @ vf).to(q.dtype)


def _lib():
    lib = _build.load("flash_attention")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.flash_attention_fwd.argtypes = [
            i, i, p, p, p, p, p, ctypes.POINTER(ctypes.c_longlong),
            i, i, i, i, i, i, p]
        lib.flash_attention_fwd.restype = ctypes.c_int
        lib._typed = True
    return lib


def flash_attention_cuda(q, k, v, *, causal=True, window=0, kv_len=None):
    """Launch ``csrc/flash_attention.cu``.  q (B, Hq, S, hd), k and v
    (B, Hkv, S, hd) of one dtype (float32 or bfloat16) on one CUDA
    device, hd 64, 96 or 128, Hq a multiple of Hkv, the head dim
    contiguous (other strides and the base aligned to 4 elements in
    float32, 8 in bfloat16, so transposed views of (B, S, H, hd)
    tensors go in as they are); kv_len an optional (B,) int32 tensor with values in
    [1, S].  Returns a (B, Hq, S, hd) view of a (B, S, Hq, hd) buffer,
    so that transposing it back to the model's layout is free.  Raises
    when grad mode is on and q, k or v requires grad: the output would
    carry no gradient."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise ValueError("flash_attention has no backward: an input "
                         "requires grad; train with models.attention."
                         "training_attention")
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("q, k and v must be 4-D (B, H, S, hd)")
    B, Hq, S, hd = q.shape
    Hkv = k.shape[1]
    if tuple(k.shape) != (B, Hkv, S, hd) or v.shape != k.shape:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"fit q {tuple(q.shape)}")
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"{Hq} query heads over {Hkv} kv heads")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd}: the kernel is built for {HEAD_DIMS}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v dtypes {q.dtype}/{k.dtype}/{v.dtype}: one "
                        "of float32, bfloat16 required")
    if window < 0:
        raise ValueError(f"window {window} < 0")
    dev = q.device
    # float32: 4-element vector loads; bfloat16: TMA, whose tensor maps
    # take 16-byte aligned bases and strides (8 elements)
    align = 4 if q.dtype == torch.float32 else 8
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"{name}: all operands on one CUDA device")
        if t.stride(-1) != 1 or any(s % align for s in t.stride()[:3]) \
                or t.data_ptr() % (align * t.element_size()):
            raise ValueError(f"{name}: head dim must be contiguous and rows "
                             f"{align}-element aligned, strides {t.stride()}")
    if kv_len is not None:
        if kv_len.dtype != torch.int32 or tuple(kv_len.shape) != (B,) \
                or kv_len.device != dev or not kv_len.is_contiguous():
            raise ValueError("kv_len: a contiguous (B,) int32 tensor on q's "
                             "device")
    out = torch.empty((B, S, Hq, hd), dtype=q.dtype,
                      device=dev).transpose(1, 2)
    if out.numel() == 0:
        return out
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (q, k, v, out) for s in t.stride()[:3]))
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.flash_attention_fwd(
            _DTYPES[q.dtype], hd, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), None if kv_len is None else kv_len.data_ptr(),
            strides, B, Hq, Hkv, S, int(causal), int(window),
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "flash_attention_fwd")
    LAUNCHES["flash_attention"] += 1
    return out


def flash_attention(q, k, v, *, causal=True, window=0, kv_len=None):
    """q (B, Hq, S, hd), k and v (B, Hkv, S, hd) -> (B, Hq, S, hd).

    The CUDA kernel for CUDA tensors, the plain version for CPU ones."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     kv_len=kv_len)
    return flash_attention_cuda(q, k, v, causal=causal, window=window,
                                kv_len=kv_len)
