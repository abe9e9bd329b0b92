"""Supervised NT-Xent (AdaSplit eq. 5), batched over clients.

Port of ``repro.kernels.ntxent``.  Per row i of each client's q (B, D):

    lse_i     = logsumexp_{j != i} (q_i . q_j / tau)
    pos_sum_i = sum_{j != i, y_j == y_i} (q_i . q_j / tau)
    pos_cnt_i = |{j != i : y_j == y_i}|

and the client's loss is ``sum(cnt * lse - pos_sum) / max(sum(cnt), 1)``
(``repro.kernels.ref.ntxent_loss_from_stats``).

For CUDA tensors ``ntxent_loss`` is one ``torch.autograd.Function``
over the hand-written kernels of ``csrc/ntxent.cu``: ONE forward launch
for all C clients (row normalisation, the statistics and the loss
reduction) and ONE backward launch (the gradient with respect to the
un-normalised q, recomputed from the saved norms).  Their plain
versions are ``ntxent_loss_forward_plain`` and the closed-form
``ntxent_loss_backward_plain``.  For CPU tensors the loss is the
normalisation and the reduction in torch ops around ``_NtxentStats``,
whose statistics come from ``ntxent_stats_plain`` and whose backward
recomputes ``sim = q q^T / tau`` from the saved q and uses the saved lse:
``P = exp(sim - lse)`` off the diagonal, ``dsim = d_lse P + d_pos_sum
pos`` and ``dq = (dsim + dsim^T) q / tau``, in torch ops (the JAX
package, too, differentiates outside its Pallas kernel).  A CUDA tensor
never reaches a plain version through this module.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

NEG = -1e30          # the TPU kernel's mask value: lse of a row alone
MAX_D = 256          # projection widths the CUDA kernels take
MAX_B = 128          # rows per client the CUDA kernels take (one CTA)

# launches of the CUDA kernels (never the plain versions): the forward
# (statistics, with the loss when called through ``ntxent_loss``) and the
# backward
LAUNCHES = {"ntxent_stats": 0, "ntxent_backward": 0}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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


def ntxent_loss_forward_plain(q, labels, tau: float = 0.07,
                              normalize: bool = True):
    """Plain version of the forward kernel: q (C, B, D), labels (C, B) ->
    (loss (C,), lse, pos_sum, pos_cnt, norms), each of the last four
    (C, B); norms None without ``normalize``."""
    q = q.to(torch.float32)
    norms = None
    if normalize:
        norms = torch.linalg.vector_norm(q, dim=-1)
        q = q / (norms[..., None] + 1e-8)
    lse, pos_sum, pos_cnt = ntxent_stats_plain(q, labels, tau)
    n_pos = pos_cnt.sum(dim=-1).clamp(min=1.0)
    return ((pos_cnt * lse - pos_sum).sum(dim=-1) / n_pos, lse, pos_sum,
            pos_cnt, norms)


def ntxent_loss_backward_plain(q, labels, d_loss, tau: float = 0.07,
                               normalize: bool = True):
    """Closed-form gradient of ``ntxent_loss`` over q (..., B, D) with
    respect to q, given d_loss (...,): the backward kernel's plain
    version.  With N = max(sum cnt, 1), ``d_lse = d_loss cnt / N`` and
    ``d_pos_sum = -d_loss / N``; ``dsim = d_lse P + d_pos_sum pos`` with
    ``P = exp(sim - lse)`` off the diagonal; ``dq = (dsim + dsim^T) q /
    tau``, and through the normaliser ``q / (n + 1e-8)``: ``dq / (n +
    1e-8) - q (q . dq) / ((n + 1e-8)^2 n)`` (0 for the second term where
    n = 0)."""
    raw = q.to(torch.float32)
    n = torch.linalg.vector_norm(raw, dim=-1, keepdim=True)
    den = n + 1e-8
    q = raw / den if normalize else raw
    sim, eye = _similarity(q, tau)
    lse = torch.logsumexp(sim.masked_fill(eye, NEG), dim=-1)
    pos = (labels[..., :, None] == labels[..., None, :]) & ~eye
    cnt = pos.sum(dim=-1).to(torch.float32)
    g = d_loss.to(torch.float32) / cnt.sum(dim=-1).clamp(min=1.0)
    p = torch.exp(sim.masked_fill(eye, float("-inf")) - lse[..., None])
    dsim = (g[..., None] * cnt)[..., None] * p - g[..., None, None] * pos
    dq = torch.matmul(dsim + dsim.transpose(-1, -2), q) / tau
    if not normalize:
        return dq
    t = -(dq * raw).sum(dim=-1, keepdim=True) / (den * den)
    zero = torch.zeros((), device=q.device)
    return dq / den + raw * torch.where(n > 0, t / n, zero)


def _lib():
    lib = _build.load("ntxent")
    if not getattr(lib, "_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.ntxent_forward_f32.argtypes = [p, p, p, p, p, p, p, i, i, i, f,
                                           i, p]
        lib.ntxent_forward_f32.restype = ctypes.c_int
        lib.ntxent_backward_f32.argtypes = [p, p, p, p, p, p, i, i, i, f, i,
                                            p]
        lib.ntxent_backward_f32.restype = ctypes.c_int
        if lib.ntxent_max_rows() != MAX_B:
            raise RuntimeError("csrc/ntxent.cu and its wrapper disagree on "
                               "MAX_B")
        lib._typed = True
    return lib


def _check(q, labels):
    """(C, B, D) of q (C, B, D) float32 and labels (C, B) int32,
    contiguous, on one CUDA device, within the kernels' limits."""
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
    if B > MAX_B:
        raise ValueError(f"{B} rows per client: the CUDA kernels hold one "
                         f"client in one CTA, at most {MAX_B} rows")
    return C, B, D


def ntxent_forward_cuda(q, labels, tau: float = 0.07, normalize: bool = True):
    """Launch the forward kernel of ``csrc/ntxent.cu``: q (C, B, D)
    float32 and labels (C, B) int32, contiguous, on one CUDA device ->
    (loss (C,), lse, pos_sum, pos_cnt, norms), each of the last four
    (C, B) float32; norms None without ``normalize``."""
    C, B, D = _check(q, labels)
    new = lambda *shape: torch.empty(shape, device=q.device,
                                     dtype=torch.float32)
    loss = new(C)
    stats = [new(C, B) for _ in range(3)]
    norms = new(C, B) if normalize else None
    if C * B == 0:
        return (loss.zero_(), *stats, norms)
    with torch.cuda.device(q.device):
        err = _lib().ntxent_forward_f32(
            q.data_ptr(), labels.data_ptr(), loss.data_ptr(),
            *(t.data_ptr() for t in stats),
            norms.data_ptr() if normalize else None, C, B, D, float(tau),
            int(normalize), torch.cuda.current_stream().cuda_stream)
    _build.check(err, "ntxent_forward_f32")
    LAUNCHES["ntxent_stats"] += 1
    return (loss, *stats, norms)


def ntxent_backward_cuda(q, labels, norms, pos_cnt, d_loss,
                         tau: float = 0.07, normalize: bool = True):
    """Launch the backward kernel of ``csrc/ntxent.cu``: the forward's q
    (C, B, D) and labels, its norms (when ``normalize``) and pos_cnt
    (C, B), and d_loss (C,) -> dq (C, B, D), the gradient with respect
    to the un-normalised q."""
    C, B, D = _check(q, labels)
    saved = [pos_cnt, d_loss] + ([norms] if normalize else [])
    for t, shape in zip(saved, [(C, B), (C,), (C, B)]):
        if t.dtype != torch.float32 or tuple(t.shape) != shape \
                or not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"contiguous float32 {shape} on {q.device} "
                             f"required, got {tuple(t.shape)} {t.dtype}")
    dq = torch.empty_like(q)
    if C * B == 0:
        return dq
    with torch.cuda.device(q.device):
        err = _lib().ntxent_backward_f32(
            q.data_ptr(), labels.data_ptr(),
            norms.data_ptr() if normalize else None, pos_cnt.data_ptr(),
            d_loss.data_ptr(), dq.data_ptr(), C, B, D,
            float(tau), int(normalize),
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "ntxent_backward_f32")
    LAUNCHES["ntxent_backward"] += 1
    return dq


def ntxent_stats_cuda(q, labels, tau: float = 0.07):
    """The forward kernel on already normalised rows: q (C, B, D) float32
    and labels (C, B) int32, contiguous, on one CUDA device -> (lse,
    pos_sum, pos_cnt), each (C, B) float32."""
    return ntxent_forward_cuda(q, labels, tau, normalize=False)[1:4]


class _NtxentStats(torch.autograd.Function):
    """The statistics of CPU tensors, differentiable in q."""

    @staticmethod
    def forward(ctx, q, labels, tau):
        lse, pos_sum, pos_cnt = ntxent_stats_plain(q, labels, tau)
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
    """Statistics of q (..., B, D) float32 and labels (..., B): (lse,
    pos_sum, pos_cnt), each (..., B).  On the CPU they are differentiable
    in q.  On the card they are the forward kernel's (``ntxent_stats_cuda``:
    q (C, B, D), labels (C, B) int32), which, like the TPU kernel, has no
    gradient: a q that needs one is refused, and ``ntxent_loss`` is the
    differentiable loss there."""
    if q.device.type == "cpu":
        return _NtxentStats.apply(q.to(torch.float32), labels, float(tau))
    if q.requires_grad and torch.is_grad_enabled():
        raise ValueError("ntxent_stats has no gradient on CUDA tensors; "
                         "differentiate ntxent_loss instead")
    return ntxent_stats_cuda(q, labels, tau)


class _NtxentLoss(torch.autograd.Function):
    """The whole loss on CUDA tensors: one forward and one backward
    launch; q (C, B, D) float32, labels (C, B) int32, both contiguous."""

    @staticmethod
    def forward(ctx, q, labels, tau, normalize):
        loss, _, _, pos_cnt, norms = ntxent_forward_cuda(q, labels, tau,
                                                         normalize)
        ctx.save_for_backward(q, labels, norms, pos_cnt)
        ctx.tau, ctx.normalize = tau, normalize
        return loss

    @staticmethod
    def backward(ctx, d_loss):
        q, labels, norms, pos_cnt = ctx.saved_tensors
        dq = ntxent_backward_cuda(q, labels, norms, pos_cnt,
                                  d_loss.contiguous(), ctx.tau,
                                  ctx.normalize)
        return dq, None, None, None


def ntxent_loss(q, labels, tau: float = 0.07, normalize: bool = True):
    """Kernel-backed supervised NT-Xent over q (..., B, D), labels
    (..., B): the mean over positive pairs per leading index, so (C, B, D)
    projections give the (C,) per-client losses of one launch.
    ``normalize`` divides each row by its norm + 1e-8 first."""
    q = q.to(torch.float32)
    if q.device.type == "cuda":
        lead, (B, D) = tuple(q.shape[:-2]), tuple(q.shape[-2:])
        loss = _NtxentLoss.apply(
            q.reshape(-1, B, D).contiguous(),
            labels.reshape(-1, B).to(torch.int32).contiguous(), float(tau),
            bool(normalize))
        return loss.reshape(lead)
    if normalize:
        q = q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + 1e-8)
    lse, pos_sum, pos_cnt = ntxent_stats(q, labels, tau)
    n_pos = pos_cnt.sum(dim=-1).clamp(min=1.0)
    return (pos_cnt * lse - pos_sum).sum(dim=-1) / n_pos
