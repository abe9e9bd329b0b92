"""Soft threshold, the L1 proximal operator ``sign(x) * max(|x| - t, 0)``.

Port of ``repro.kernels.soft_threshold``: any shape, computed in float32
and written in x's dtype (float32 or bfloat16).  For CUDA tensors the
call launches the hand-written kernel ``csrc/soft_threshold.cu`` over
the flattened tensor; for CPU tensors it runs the plain PyTorch version
below, which does the same float32 operations.  A CUDA tensor never
reaches the plain version through this module.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# launches of the CUDA kernel (never the plain version)
LAUNCHES = {"soft_threshold": 0}


def reset_launches():
    LAUNCHES["soft_threshold"] = 0


def soft_threshold_plain(x, threshold: float):
    """Plain PyTorch version, the reference's arithmetic: float32
    ``sign(x) * max(|x| - t, 0)``, cast back to x's dtype."""
    xf = x.to(torch.float32)
    return (torch.sign(xf) * torch.clamp_min(xf.abs() - threshold, 0.0)
            ).to(x.dtype)


def _lib():
    lib = _build.load("soft_threshold")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.soft_threshold.argtypes = [p, p, ctypes.c_longlong,
                                       ctypes.c_float, i, i, p]
        lib.soft_threshold.restype = ctypes.c_int
        lib._typed = True
    return lib


def soft_threshold_cuda(x, threshold: float):
    """Launch ``csrc/soft_threshold.cu`` on a contiguous float32 or
    bfloat16 CUDA tensor; returns a new tensor of x's shape and dtype."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"float32 or bfloat16 required, got {x.dtype}")
    if x.device.type != "cuda":
        raise ValueError(f"a CUDA tensor required, got {x.device}")
    if not x.is_contiguous():
        raise ValueError("contiguous tensor required")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        err = _lib().soft_threshold(
            x.data_ptr(), out.data_ptr(), x.numel(), float(threshold),
            _DTYPES[x.dtype], _build.sm_count(x.device),
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "soft_threshold")
    LAUNCHES["soft_threshold"] += 1
    return out


def soft_threshold(x, threshold: float):
    """The kernel for a CUDA tensor, the plain version for a CPU one."""
    if x.device.type == "cpu":
        return soft_threshold_plain(x, threshold)
    return soft_threshold_cuda(x.contiguous(), threshold)
