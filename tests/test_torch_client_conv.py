"""Port parity: ``repro_torch.kernels.client_conv`` against the reference
``repro.kernels.client_conv.client_conv(method="pallas")``, which runs the
Pallas panel-GEMM kernels in interpret mode on the CPU.

Inputs are made with numpy from a seed and handed to both.  Tolerance:
both sides sum K = 25*Cin <= 400 float32 products in different orders
(Pallas' interpreted dot vs the port's plain broadcast-sum), so values
of order 1 agree to ~1e-6; 2e-5 absolute/relative leaves margin and is
still far below any real indexing or layout fault."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import client_conv as jcc
from repro_torch.kernels import client_conv as tcc

TOL = 2e-5
RNG = np.random.default_rng(7)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _inputs(lead, B, H, W, cin, cout, k=5):
    x = RNG.normal(size=lead + (B, H, W, cin)).astype(np.float32)
    w = (RNG.normal(size=lead + (k, k, cin, cout))
         / np.sqrt(k * k * cin)).astype(np.float32)
    bias = RNG.normal(size=lead + (cout,)).astype(np.float32)
    return x, w, bias


# (lead, B, H, W, cin, cout): the LeNet block shapes at small C and B —
# client block 3->6, server blocks 6->16, 16->32, 32->64 — plus ragged M,
# K and N (odd, non-square spatial; Cin and Cout off every tile size)
SHAPES = [
    pytest.param((2,), 2, 16, 16, 3, 6, id="client_block_stacked"),
    pytest.param((), 4, 8, 8, 6, 16, id="server_block1"),
    pytest.param((), 3, 4, 4, 16, 32, id="server_block2"),
    pytest.param((), 5, 2, 2, 32, 64, id="server_block3"),
    pytest.param((3,), 1, 7, 5, 5, 3, id="ragged_stacked"),
    pytest.param((), 2, 9, 3, 7, 9, id="ragged_unstacked"),
]


@pytest.mark.parametrize("lead,B,H,W,cin,cout", SHAPES)
@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_client_conv_forward_matches_pallas(lead, B, H, W, cin, cout, fused):
    x, w, bias = _inputs(lead, B, H, W, cin, cout)
    kw = dict(bias=jnp.asarray(bias), fused_epilogue=True) if fused else {}
    want = jcc.client_conv(jnp.asarray(x), jnp.asarray(w), method="pallas",
                           **kw)
    tkw = dict(bias=torch.from_numpy(bias), fused_epilogue=True) \
        if fused else {}
    got = tcc.client_conv(torch.from_numpy(x), torch.from_numpy(w), **tkw)
    assert tuple(got.shape) == want.shape
    _close(got, want)


@pytest.mark.parametrize("lead,B,H,W,cin,cout", SHAPES[:1] + SHAPES[4:])
@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_client_conv_grads_match_jax(lead, B, H, W, cin, cout, fused):
    """Gradients wrt x, w (and the bias) against ``jax.grad`` through the
    reference's custom VJP, for loss = sum(conv * R)."""
    x, w, bias = _inputs(lead, B, H, W, cin, cout)
    r = RNG.normal(size=x.shape[:-1] + (cout,)).astype(np.float32)

    def jloss(x, w, b):
        kw = dict(bias=b, fused_epilogue=True) if fused else {}
        return jnp.sum(jcc.client_conv(x, w, method="pallas", **kw) * r)

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias))
    tx, tw, tb = (torch.from_numpy(a).requires_grad_(True)
                  for a in (x, w, bias))
    kw = dict(bias=tb, fused_epilogue=True) if fused else {}
    (tcc.client_conv(tx, tw, **kw) * torch.from_numpy(r)).sum().backward()
    _close(tx.grad, want[0])
    _close(tw.grad, want[1])
    if fused:
        _close(tb.grad, want[2])


def test_im2col_and_panels_match_reference_exactly():
    """Patch building is pure data movement: bit-equal to the reference's
    (ki, kj, cin) order, stacked and unstacked."""
    x, w, _ = _inputs((2,), 3, 6, 7, 4, 5)
    pj, wj, shape_j = jcc._panels(jnp.asarray(x), jnp.asarray(w))
    pt, wt, shape_t = tcc._panels(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))
    assert shape_t == shape_j
    np.testing.assert_array_equal(
        tcc.im2col(torch.from_numpy(x[0]), 3).numpy(),
        np.asarray(jcc.im2col(jnp.asarray(x[0]), 3)))


def test_client_proj_matches_reference():
    C, M, D = 3, 5, 12
    h = RNG.normal(size=(C, M, D)).astype(np.float32)
    proj = {"w1": RNG.normal(size=(C, D, 128)).astype(np.float32) * 0.1,
            "b1": RNG.normal(size=(C, 128)).astype(np.float32),
            "w2": RNG.normal(size=(C, 128, 7)).astype(np.float32) * 0.1}
    want = jcc.client_proj({k: jnp.asarray(v) for k, v in proj.items()},
                           jnp.asarray(h))
    got = tcc.client_proj({k: torch.from_numpy(v) for k, v in proj.items()},
                          torch.from_numpy(h))
    _close(got, want)


def test_cpu_tensors_take_the_plain_version_and_never_count():
    tcc.reset_launches()
    x, w, bias = _inputs((2,), 1, 4, 4, 3, 6)
    tcc.client_conv(torch.from_numpy(x), torch.from_numpy(w))
    tcc.client_conv(torch.from_numpy(x), torch.from_numpy(w),
                    bias=torch.from_numpy(bias), fused_epilogue=True)
    assert tcc.LAUNCHES == {"panel_gemm": 0, "panel_gemm_bias_relu": 0}


def test_cuda_wrapper_refuses_cpu_tensors():
    """The kernel wrapper never computes on the CPU: it launches on a
    CUDA device or raises."""
    a = torch.zeros((1, 4, 3))
    b = torch.zeros((1, 3, 2))
    with pytest.raises(ValueError):
        tcc.panel_gemm_cuda(a, b)
    with pytest.raises(TypeError):
        tcc.panel_gemm_cuda(a.double(), b.double())
