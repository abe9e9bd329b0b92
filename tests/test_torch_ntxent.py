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
