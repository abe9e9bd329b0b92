"""Port parity: ``repro_torch.kernels.ntxent`` (supervised NT-Xent
statistics, batched over clients, and the loss and gradient built on
them) against the JAX package: the Pallas ``ntxent_stats`` kernel in
interpret mode, its oracle ``ref.ntxent_stats_ref``, the kernel-backed
``ops.ntxent_loss`` and ``jax.grad`` of ``core.losses.ntxent_supervised``.

On the CPU the port's statistics come from the plain PyTorch version
through the same ``autograd.Function`` the card uses, so its
hand-written backward is what is checked here.  Every case has C=3
clients and a label held by one example (its row has no positive; at
B=2 no row has one and the loss is 0).

Tolerance: 1e-5 relative, measured against the largest magnitude of the
compared array — both sides are float32 with other summation orders, and
positive sums and gradient entries can cancel to near 0, where an
element-wise relative bound would measure rounding noise."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.losses import ntxent_supervised as jntxent_supervised
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.ntxent import ntxent_stats as jntxent_stats
from repro_torch.core.losses import ntxent_supervised
from repro_torch.kernels import ntxent as tnt
from repro_torch.kernels import ops as tops

C = 3
CASES = [(B, D, tau) for B in (2, 7, 32, 33) for D in (16, 64)
         for tau in (0.07, 0.5)]
RTOL = 1e-5


def _inputs(B, D, seed=0):
    """(C, B, D) raw projections and (C, B) int32 labels; label 99 is
    held by example 0 of each client alone."""
    rng = np.random.default_rng(seed + 1000 * B + D)
    q = rng.normal(size=(C, B, D)).astype(np.float32)
    y = rng.integers(0, 3, size=(C, B)).astype(np.int32)
    y[:, 0] = 99
    return q, y


def _normalized(q):
    return (q / (np.linalg.norm(q, axis=-1, keepdims=True) + 1e-8)
            ).astype(np.float32)


def _close(got, want):
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max(initial=0.0)), 1e-30)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=RTOL,
                               atol=RTOL * scale)


IDS = ["B{}-D{}-tau{}".format(*c) for c in CASES]


@pytest.mark.parametrize("B,D,tau", CASES, ids=IDS)
def test_stats_match_pallas_kernel_and_oracle(B, D, tau):
    q, y = _inputs(B, D)
    qn = _normalized(q)
    lse, pos_sum, pos_cnt = (t.numpy() for t in tnt.ntxent_stats_plain(
        torch.from_numpy(qn), torch.from_numpy(y), tau))
    assert lse.shape == pos_sum.shape == pos_cnt.shape == (C, B)
    pallas = jax.jit(lambda qq, yy: jntxent_stats(qq, yy, tau,
                                                  interpret=True))
    for c in range(C):
        for want in (pallas(qn[c], y[c]),
                     jref.ntxent_stats_ref(jnp.asarray(qn[c]), y[c], tau)):
            _close(lse[c], want[0])
            _close(pos_sum[c], want[1])
            np.testing.assert_array_equal(pos_cnt[c], np.asarray(want[2]))
        # batched over clients against one client at a time (a batched
        # matmul may sum in another order than a single one)
        one = tnt.ntxent_stats_plain(torch.from_numpy(qn[c]),
                                     torch.from_numpy(y[c]), tau)
        for a, b in zip((lse, pos_sum, pos_cnt), one):
            _close(a[c], b.numpy())
    assert np.all(pos_cnt[:, 0] == 0)


@pytest.mark.parametrize("B,D,tau", CASES, ids=IDS)
def test_loss_matches_reference(B, D, tau):
    q, y = _inputs(B, D, seed=1)
    got = tops.ntxent_loss(torch.from_numpy(q), torch.from_numpy(y),
                           tau).numpy()
    assert got.shape == (C,)
    port_plain = ntxent_supervised(torch.from_numpy(q), torch.from_numpy(y),
                                   tau).numpy()
    for c in range(C):
        kernel_ref = float(jops.ntxent_loss(jnp.asarray(q[c]),
                                            jnp.asarray(y[c]), tau))
        plain_ref = float(jntxent_supervised(jnp.asarray(q[c]),
                                             jnp.asarray(y[c]), tau))
        for want in (kernel_ref, plain_ref, port_plain[c]):
            np.testing.assert_allclose(got[c], want, rtol=RTOL, atol=1e-7)
    if B == 2:
        np.testing.assert_array_equal(got, 0.0)


@pytest.mark.parametrize("B,D,tau", CASES, ids=IDS)
def test_gradient_matches_jax_grad(B, D, tau):
    q, y = _inputs(B, D, seed=2)
    qt = torch.from_numpy(q).requires_grad_(True)
    tnt.ntxent_loss(qt, torch.from_numpy(y), tau).sum().backward()

    def total(qq):
        per = jax.vmap(lambda a, b: jntxent_supervised(a, b, tau))(
            qq, jnp.asarray(y))
        return jnp.sum(per)
    want = np.asarray(jax.grad(total)(jnp.asarray(q)))
    for c in range(C):
        if B == 2:                    # no positive pair: the loss is 0
            np.testing.assert_array_equal(qt.grad[c].numpy(), 0.0)
        else:
            _close(qt.grad[c].numpy(), want[c])


def test_cpu_tensors_take_the_plain_version_and_cuda_wrapper_refuses_them():
    q, y = _inputs(7, 16)
    tnt.reset_launches()
    tnt.ntxent_loss(torch.from_numpy(q), torch.from_numpy(y))
    assert tnt.LAUNCHES["ntxent_stats"] == 0
    with pytest.raises(ValueError, match="CUDA device"):
        tnt.ntxent_stats_cuda(torch.from_numpy(q), torch.from_numpy(y))
    with pytest.raises(TypeError, match="int32 labels"):
        tnt.ntxent_stats_cuda(torch.from_numpy(q),
                              torch.from_numpy(y).long())
    assert tnt.LAUNCHES["ntxent_stats"] == 0



def test_stats_off_the_cpu_never_take_the_plain_version():
    """Off the CPU (here the meta device) ``ntxent_stats`` goes to the
    CUDA wrapper, which refuses a non-CUDA tensor, and refuses first a q
    that needs a gradient: no tensor off the CPU reaches a plain
    version."""
    q = torch.zeros((2, 4, 8), device="meta")
    y = torch.zeros((2, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no gradient"):
        tnt.ntxent_stats(q.requires_grad_(True), y)
    with pytest.raises(ValueError, match="CUDA device"):
        tnt.ntxent_stats(q.detach(), y)

# --- the fused CUDA path's plain versions, and the CPU path unchanged ---

def _parent_loss(q, labels, tau):
    """``ntxent_loss`` on the CPU as the port had it before the fused
    kernels, verbatim (its ``autograd.Function`` included): the CPU path
    must stay bit-for-bit this."""
    def similarity(q):
        B = q.shape[-2]
        sim = torch.matmul(q, q.transpose(-1, -2)) / tau
        return sim, torch.eye(B, dtype=torch.bool, device=q.device)

    def stats_plain(q):
        sim, eye = similarity(q.to(torch.float32))
        lse = torch.logsumexp(sim.masked_fill(eye, -1e30), dim=-1)
        pos = (labels[..., :, None] == labels[..., None, :]) & ~eye
        zero = torch.zeros((), device=q.device)
        pos_sum = torch.where(pos, sim, zero).sum(dim=-1)
        return lse, pos_sum, pos.sum(dim=-1).to(torch.float32)

    class Stats(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q):
            lse, pos_sum, pos_cnt = stats_plain(q)
            ctx.save_for_backward(q, lse)
            ctx.mark_non_differentiable(pos_cnt)
            return lse, pos_sum, pos_cnt

        @staticmethod
        def backward(ctx, d_lse, d_pos_sum, _):
            q, lse = ctx.saved_tensors
            sim, eye = similarity(q)
            p = torch.exp(sim.masked_fill(eye, float("-inf"))
                          - lse[..., None])
            pos = (labels[..., :, None] == labels[..., None, :]) & ~eye
            dsim = d_lse[..., None] * p + d_pos_sum[..., None] * pos
            return torch.matmul(dsim + dsim.transpose(-1, -2), q) / tau

    q = q.to(torch.float32)
    q = q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + 1e-8)
    lse, pos_sum, pos_cnt = Stats.apply(q)
    n_pos = pos_cnt.sum(dim=-1).clamp(min=1.0)
    return (pos_cnt * lse - pos_sum).sum(dim=-1) / n_pos


def _d_loss(seed):
    return np.random.default_rng(seed).uniform(0.5, 2.0, size=C).astype(
        np.float32)


@pytest.mark.parametrize("B,D,tau", CASES, ids=IDS)
def test_cpu_path_bit_equal_to_parent(B, D, tau):
    """On the CPU the loss, the statistics and the gradient through the
    autograd path are the port's outputs before the fused kernels, bit
    for bit (tolerance 0); no kernel launches."""
    q, y = _inputs(B, D, seed=3)
    dl = torch.from_numpy(_d_loss(B))
    tnt.reset_launches()
    got_q = torch.from_numpy(q).requires_grad_(True)
    got = tnt.ntxent_loss(got_q, torch.from_numpy(y), tau)
    (got * dl).sum().backward()
    want_q = torch.from_numpy(q).requires_grad_(True)
    want = _parent_loss(want_q, torch.from_numpy(y), tau)
    (want * dl).sum().backward()
    assert torch.equal(got, want) and torch.equal(got_q.grad, want_q.grad)
    qn = torch.from_numpy(_normalized(q))
    for a, b in zip(tnt.ntxent_stats_plain(qn, torch.from_numpy(y), tau),
                    _parent_stats(qn, torch.from_numpy(y), tau)):
        assert torch.equal(a, b)
    assert tnt.LAUNCHES == {"ntxent_stats": 0, "ntxent_backward": 0}


def _parent_stats(q, labels, tau):
    B = q.shape[-2]
    sim = torch.matmul(q, q.transpose(-1, -2)) / tau
    eye = torch.eye(B, dtype=torch.bool)
    lse = torch.logsumexp(sim.masked_fill(eye, -1e30), dim=-1)
    pos = (labels[..., :, None] == labels[..., None, :]) & ~eye
    pos_sum = torch.where(pos, sim, torch.zeros(())).sum(dim=-1)
    return lse, pos_sum, pos.sum(dim=-1).to(torch.float32)


@pytest.mark.parametrize("B,D,tau", CASES, ids=IDS)
def test_forward_plain_matches_cpu_loss(B, D, tau):
    """The forward kernel's plain version: the CPU loss bit for bit, the
    statistics of the normalised rows and their norms."""
    q, y = _inputs(B, D, seed=4)
    qt, yt = torch.from_numpy(q), torch.from_numpy(y)
    loss, lse, pos_sum, pos_cnt, norms = tnt.ntxent_loss_forward_plain(
        qt, yt, tau)
    assert torch.equal(loss, tnt.ntxent_loss(qt, yt, tau))
    want = tnt.ntxent_stats_plain(torch.from_numpy(_normalized(q)), yt, tau)
    for a, b in zip((lse, pos_sum, pos_cnt), want):
        _close(a.numpy(), b.numpy())
    _close(norms.numpy(), np.linalg.norm(q, axis=-1))
    raw = tnt.ntxent_loss_forward_plain(qt, yt, tau, normalize=False)
    assert raw[4] is None
    assert torch.equal(raw[0], tnt.ntxent_loss(qt, yt, tau, normalize=False))


@pytest.mark.parametrize("normalize", [True, False], ids=["norm", "raw"])
@pytest.mark.parametrize("B,D,tau", CASES, ids=IDS)
def test_backward_plain_matches_autograd_and_jax(B, D, tau, normalize):
    """The backward kernel's plain version against torch autograd through
    the CPU path and ``jax.grad`` of the reference: the Pallas kernel's
    oracle (``ref.ntxent_stats_ref``, as ``kernels.ntxent.ntxent_loss``
    wraps the kernel; JAX cannot differentiate the Pallas call itself)
    and ``core.losses.ntxent_supervised``.  Rows without a positive in
    every case; at B=2 no row has one and the gradient is exactly 0."""
    q, y = _inputs(B, D, seed=5)
    dl = _d_loss(B + D)
    got = tnt.ntxent_loss_backward_plain(
        torch.from_numpy(q), torch.from_numpy(y), torch.from_numpy(dl), tau,
        normalize=normalize).numpy()
    qt = torch.from_numpy(q).requires_grad_(True)
    loss = tnt.ntxent_loss(qt, torch.from_numpy(y), tau, normalize=normalize)
    (loss * torch.from_numpy(dl)).sum().backward()

    def oracle(qq, yy):
        if normalize:
            qq = qq / (jnp.linalg.norm(qq, axis=-1, keepdims=True) + 1e-8)
        return jref.ntxent_loss_from_stats(*jref.ntxent_stats_ref(qq, yy,
                                                                  tau))

    def total(qq, loss_fn):
        per = jax.vmap(loss_fn)(qq, jnp.asarray(y))
        return jnp.sum(per * jnp.asarray(dl))
    wants = [qt.grad.numpy(), np.asarray(jax.grad(total)(jnp.asarray(q),
                                                         oracle))]
    if normalize:
        wants.append(np.asarray(jax.grad(total)(
            jnp.asarray(q), lambda a, b: jntxent_supervised(a, b, tau))))
    for c in range(C):
        if B == 2:
            np.testing.assert_array_equal(got[c], 0.0)
        for want in wants:
            _close(got[c], want[c])
