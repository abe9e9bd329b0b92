"""Supervised NT-Xent statistics (AdaSplit eq. 5), batched over clients.

Port of ``repro.kernels.ntxent``.  Per row i of each client's q (B, D):

    lse_i     = logsumexp_{j != i} (q_i . q_j / tau)
    pos_sum_i = sum_{j != i, y_j == y_i} (q_i . q_j / tau)
    pos_cnt_i = |{j != i : y_j == y_i}|

and the client's loss is ``sum(cnt * lse - pos_sum) / max(sum(cnt), 1)``
(``repro.kernels.ref.ntxent_loss_from_stats``).  For CUDA tensors the
statistics come from the hand-written kernel ``csrc/ntxent.cu``, one
launch for all C clients; for CPU tensors from the plain PyTorch version
below.  A CUDA tensor never reaches the plain version through this
module.

The gradient is a ``torch.autograd.Function`` whose backward recomputes
``sim = q q^T / tau`` from the saved q and uses the saved lse:
``P = exp(sim - lse)`` off the diagonal, ``dsim = d_lse P + d_pos_sum
pos`` and ``dq = (dsim + dsim^T) q / tau``, in torch ops (the JAX
package, too, differentiates outside its Pallas kernel).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

NEG = -1e30          # the TPU kernel's mask value: lse of a row alone
MAX_D = 256          # projection widths the CUDA kernel takes

# launches of the CUDA kernel (never the plain version)
LAUNCHES = {"ntxent_stats": 0}


def reset_launches():
    LAUNCHES["ntxent_stats"] = 0


def _similarity(q, tau):
    """(sim (..., B, B), diagonal mask (B, B))."""
    B = q.shape[-2]
    sim = torch.matmul(q, q.transpose(-1, -2)) / tau
    return sim, torch.eye(B, dtype=torch.bool, device=q.device)


def ntxent_stats_plain(q, labels, tau: float = 0.07):
    """Plain PyTorch version: q (..., B, D) float32, labels (..., B) ->
    (lse, pos_sum, pos_cnt), each (..., B) float32.  The diagonal is
    masked with -1e30 inside the logsumexp, as in the TPU kernel."""
    sim, eye = _similarity(q.to(torch.float32), tau)
    lse = torch.logsumexp(sim.masked_fill(eye, NEG), dim=-1)
    pos = (labels[..., :, None] == labels[..., None, :]) & ~eye
    zero = torch.zeros((), device=q.device)
    pos_sum = torch.where(pos, sim, zero).sum(dim=-1)
    return lse, pos_sum, pos.sum(dim=-1).to(torch.float32)


def _lib():
    lib = _build.load("ntxent")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ntxent_stats_f32.argtypes = [p, p, p, p, p, i, i, i,
                                         ctypes.c_float, p]
        lib.ntxent_stats_f32.restype = ctypes.c_int
        lib._typed = True
    return lib


def ntxent_stats_cuda(q, labels, tau: float = 0.07):
    """Launch ``csrc/ntxent.cu``: q (C, B, D) float32 and labels (C, B)
    int32, contiguous, on one CUDA device -> (lse, pos_sum, pos_cnt),
    each (C, B) float32."""
    if q.dtype != torch.float32 or labels.dtype != torch.int32:
        raise TypeError(f"float32 q and int32 labels required, got "
                        f"{q.dtype} and {labels.dtype}")
    if q.ndim != 3 or tuple(labels.shape) != tuple(q.shape[:2]):
        raise ValueError(f"q (C, B, D) and labels (C, B) required, got "
                         f"{tuple(q.shape)} and {tuple(labels.shape)}")
    if not (q.is_contiguous() and labels.is_contiguous()):
        raise ValueError("contiguous q and labels required")
    if q.device.type != "cuda" or labels.device != q.device:
        raise ValueError(f"q and labels must share one CUDA device, got "
                         f"{q.device} and {labels.device}")
    C, B, D = q.shape
    if not 0 < D <= MAX_D:
        raise ValueError(f"projection width {D} outside 1..{MAX_D}")
    outs = [torch.empty((C, B), device=q.device, dtype=torch.float32)
            for _ in range(3)]
    if C * B == 0:
        return tuple(outs)
    with torch.cuda.device(q.device):
        err = _lib().ntxent_stats_f32(
            q.data_ptr(), labels.data_ptr(), outs[0].data_ptr(),
            outs[1].data_ptr(), outs[2].data_ptr(), C, B, D, float(tau),
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "ntxent_stats_f32")
    LAUNCHES["ntxent_stats"] += 1
    return tuple(outs)


def _forward(q, labels, tau):
    """The kernel for CUDA tensors, the plain version for CPU tensors;
    any leading axes, flattened into the kernel's client axis."""
    if q.device.type == "cpu":
        return ntxent_stats_plain(q, labels, tau)
    lead, (B, D) = tuple(q.shape[:-2]), tuple(q.shape[-2:])
    outs = ntxent_stats_cuda(q.reshape(-1, B, D).contiguous(),
                             labels.reshape(-1, B).to(torch.int32)
                             .contiguous(), tau)
    return tuple(o.reshape(lead + (B,)) for o in outs)


class _NtxentStats(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, labels, tau):
        lse, pos_sum, pos_cnt = _forward(q, labels, tau)
        ctx.save_for_backward(q, labels, lse)
        ctx.tau = tau
        ctx.mark_non_differentiable(pos_cnt)
        return lse, pos_sum, pos_cnt

    @staticmethod
    def backward(ctx, d_lse, d_pos_sum, _):
        q, labels, lse = ctx.saved_tensors
        sim, eye = _similarity(q, ctx.tau)
        p = torch.exp(sim.masked_fill(eye, float("-inf")) - lse[..., None])
        pos = (labels[..., :, None] == labels[..., None, :]) & ~eye
        dsim = d_lse[..., None] * p + d_pos_sum[..., None] * pos
        dq = torch.matmul(dsim + dsim.transpose(-1, -2), q) / ctx.tau
        return dq, None, None


def ntxent_stats(q, labels, tau: float = 0.07):
    """Differentiable (in q) statistics of q (..., B, D) float32 and
    labels (..., B): (lse, pos_sum, pos_cnt), each (..., B)."""
    return _NtxentStats.apply(q.to(torch.float32), labels, float(tau))


def ntxent_loss(q, labels, tau: float = 0.07, normalize: bool = True):
    """Kernel-backed supervised NT-Xent over q (..., B, D), labels
    (..., B): the mean over positive pairs per leading index, so (C, B, D)
    projections give the (C,) per-client losses of one launch.
    ``normalize`` divides each row by its norm + 1e-8 first."""
    q = q.to(torch.float32)
    if normalize:
        q = q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + 1e-8)
    lse, pos_sum, pos_cnt = ntxent_stats(q, labels, tau)
    n_pos = pos_cnt.sum(dim=-1).clamp(min=1.0)
    return (pos_cnt * lse - pos_sum).sum(dim=-1) / n_pos
