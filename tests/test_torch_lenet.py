"""Port parity: the LeNet forwards and the losses of ``repro_torch``
against the reference on parameters the reference initialised, carried
across through ``weights.from_numpy`` — values and gradients against
``jax.grad``.

Tolerances: float32 on both sides with different summation orders
(im2col GEMM vs the reference's einsum, torch vs XLA reductions) over at
most a few thousand terms per output, so 1e-5 relative / 1e-5 absolute
on values of order 1; gradients, which sum over the batch as well,
take 1e-4."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.core import losses as jloss
from repro.core import masks as jmasks
from repro.models import lenet as jlenet
from repro_torch.configs.base import get_config as tget_config
from repro_torch.core import losses as tloss
from repro_torch.core import masks as tmasks
from repro_torch.models import lenet as tlenet
from repro_torch.weights import from_numpy, tree_leaves

RNG = np.random.default_rng(5)
SMALL = dict(image_size=16, conv_channels=(4, 8, 8))
# lenet-cifar at full width, split after conv block 1 (mu 0.2, the
# config's own), 2 (mu 0.5) and 4 (mu 0.75): the split points Table 3
# sweeps
SHAPES = [{}, SMALL, dict(mu=0.5), dict(mu=0.75)]
SHAPE_IDS = ["lenet_cifar", "small", "lenet_cifar_mu0.5",
             "lenet_cifar_mu0.75"]


def _cfgs(**kw):
    return (dataclasses.replace(jget_config("lenet-cifar"), **kw),
            dataclasses.replace(tget_config("lenet-cifar"), **kw))


def _close(got, want, tol=1e-5):
    for a, b in zip(tree_leaves(got), tree_leaves(jax.tree.leaves(want))):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol,
                                   atol=tol)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _gates(cfg, lead):
    s = jlenet.split_index(cfg)
    units = list(cfg.conv_channels[s:]) + [120, cfg.d_model]
    g = [RNG.uniform(0.5, 1.5, size=lead + (u,)).astype(np.float32)
         for u in units]
    return {"blocks": g[:-2], "fc1": g[-2], "fc2": g[-1]}


def test_configs_agree_with_reference():
    jc, tc = _cfgs()
    for f in ("name", "family", "source", "image_size", "n_classes",
              "conv_channels", "d_model", "mu", "is_conv"):
        assert getattr(tc, f) == getattr(jc, f), f
    assert tlenet.split_index(tc) == jlenet.split_index(jc) == 1


def test_split_points_of_the_mu_cases():
    for kw, split in zip(SHAPES[2:], (2, 4)):
        jc, tc = _cfgs(**kw)
        assert tlenet.split_index(tc) == jlenet.split_index(jc) == split


@pytest.mark.parametrize("kw", SHAPES, ids=SHAPE_IDS)
def test_client_forward_matches(kw):
    jc, tc = _cfgs(**kw)
    C, B = 2, 3
    cps = [_np(jlenet.init_client_params(jc, jax.random.PRNGKey(i)))
           for i in range(C)]
    x = RNG.random(size=(C, B, jc.image_size, jc.image_size, 3)
                   ).astype(np.float32)
    # unstacked, one client
    want = jlenet.client_forward(jc, cps[0], jnp.asarray(x[0]),
                                 batched_conv=True)
    got = tlenet.client_forward(tc, from_numpy(cps[0], "cpu"),
                                torch.from_numpy(x[0]))
    _close(got, want)
    # stacked, all clients in one call
    stacked = jax.tree.map(lambda *l: np.stack(l), *cps)
    want = jlenet.client_forward(jc, stacked, jnp.asarray(x),
                                 batched_conv=True)
    for fused in (False, True):
        got = tlenet.client_forward(tc, from_numpy(stacked, "cpu"),
                                    torch.from_numpy(x),
                                    fused_epilogue=fused)
        _close(got, want)


@pytest.mark.parametrize("gate_kind", ["none", "per_client", "per_example"])
@pytest.mark.parametrize("kw", SHAPES, ids=SHAPE_IDS)
def test_server_forward_and_grads_match(gate_kind, kw):
    jc, tc = _cfgs(**kw)
    B = 4
    sp = _np(jlenet.init_server_params(jc, jax.random.PRNGKey(1)))
    s = jlenet.split_index(jc)
    hw = jc.image_size // 2 ** s
    acts = RNG.random(size=(B, hw, hw, jc.conv_channels[s - 1])
                      ).astype(np.float32)
    gates = {"none": None, "per_client": _gates(jc, ()),
             "per_example": _gates(jc, (B,))}[gate_kind]
    r = RNG.normal(size=(B, jc.n_classes)).astype(np.float32)

    def jf(sp, gates, acts):
        logits, _ = jlenet.server_forward(jc, sp, acts, gates=gates,
                                          batched_conv=True)
        return jnp.sum(logits * r), logits

    (_, want), want_g = jax.jit(jax.value_and_grad(jf, argnums=(0, 1, 2),
                                                   has_aux=True))(
        jax.tree.map(jnp.asarray, sp),
        None if gates is None else jax.tree.map(jnp.asarray, gates),
        jnp.asarray(acts))
    tsp = from_numpy(sp, "cpu")
    tg = None if gates is None else from_numpy(gates, "cpu")
    ta = torch.from_numpy(acts)
    leaves = tree_leaves(tsp) + ([] if tg is None else tree_leaves(tg)) + [ta]
    for t in leaves:
        t.requires_grad_(True)
    logits, _ = tlenet.server_forward(tc, tsp, ta, gates=tg)
    _close(logits.detach(), want)
    grads = torch.autograd.grad((logits * torch.from_numpy(r)).sum(), leaves)
    _close(grads, [l for g in want_g if g is not None
                   for l in jax.tree.leaves(g)], tol=1e-4)


def test_stacked_server_forward_matches_vmap():
    """Per-client effective weights (the per-scalar mask mode) as one
    stacked forward == the reference's vmap over clients."""
    jc, tc = _cfgs(**SMALL)
    S, B = 3, 2
    sps = [_np(jlenet.init_server_params(jc, jax.random.PRNGKey(i)))
           for i in range(S)]
    stacked = jax.tree.map(lambda *l: np.stack(l), *sps)
    acts = RNG.random(size=(S, B, 8, 8, 4)).astype(np.float32)
    want = jax.vmap(lambda p, a: jlenet.server_forward(
        jc, p, a, batched_conv=True)[0])(jax.tree.map(jnp.asarray, stacked),
                                         jnp.asarray(acts))
    for fused in (False, True):
        got, _ = tlenet.server_forward(tc, from_numpy(stacked, "cpu"),
                                       torch.from_numpy(acts),
                                       fused_epilogue=fused)
        _close(got, want)


def test_maxpool_gradient_goes_to_first_tied_maximum():
    """``reduce_window`` max routes each window's gradient to ONE maximum
    (the first in row-major window order); an ``amax`` backward would
    split it among ties.  Inputs with many exact ties (and odd edges,
    which VALID pooling drops)."""
    y = RNG.integers(0, 3, size=(2, 5, 7, 3)).astype(np.float32)
    r = RNG.normal(size=(2, 2, 3, 3)).astype(np.float32)

    def jpool(y):
        return jax.lax.reduce_window(y, -jnp.inf, jax.lax.max, (1, 2, 2, 1),
                                     (1, 2, 2, 1), "VALID")

    want = jpool(jnp.asarray(y))
    want_g = jax.grad(lambda y: jnp.sum(jpool(y) * r))(jnp.asarray(y))
    ty = torch.from_numpy(y).requires_grad_(True)
    got = tlenet.maxpool2x2(ty)
    (got * torch.from_numpy(r)).sum().backward()
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    np.testing.assert_array_equal(ty.grad.numpy(), np.asarray(want_g))


def test_ntxent_batched_matches_vmap_with_grads():
    C, B, D = 3, 8, 16
    q = RNG.normal(size=(C, B, D)).astype(np.float32)
    y = RNG.integers(0, 3, size=(C, B)).astype(np.int32)
    y[1] = np.arange(B)                     # a client with no positives
    want, want_g = jax.value_and_grad(lambda q: jnp.sum(jax.vmap(
        lambda q, y: jloss.ntxent_supervised(q, y, 0.07))(q, jnp.asarray(y))
        * jnp.arange(1.0, C + 1)))(jnp.asarray(q))
    per_client = jax.vmap(lambda q, y: jloss.ntxent_supervised(q, y, 0.07))(
        jnp.asarray(q), jnp.asarray(y))
    tq = torch.from_numpy(q).requires_grad_(True)
    got = tloss.ntxent_supervised(tq, torch.from_numpy(y), 0.07)
    (got * torch.arange(1.0, C + 1)).sum().backward()
    _close(got.detach(), per_client)
    assert torch.isfinite(tq.grad).all()
    _close(tq.grad, want_g, tol=1e-4)


def test_cross_entropy_l1_accuracy_with_grads():
    logits = RNG.normal(size=(6, 10)).astype(np.float32) * 3
    y = RNG.integers(0, 10, size=(6,)).astype(np.int32)
    want, want_g = jax.value_and_grad(jloss.cross_entropy)(
        jnp.asarray(logits), jnp.asarray(y))
    tl = torch.from_numpy(logits).requires_grad_(True)
    got = tloss.cross_entropy(tl, torch.from_numpy(y))
    got.backward()
    _close(got.detach(), want)
    _close(tl.grad, want_g)

    masks = {"blocks": [RNG.normal(size=(3, 4)).astype(np.float32)],
             "fc1": RNG.normal(size=(3, 5)).astype(np.float32)}
    want, want_g = jax.value_and_grad(jloss.l1_penalty)(
        jax.tree.map(jnp.asarray, masks))
    tm = from_numpy(masks, "cpu")
    for t in tree_leaves(tm):
        t.requires_grad_(True)
    got = tloss.l1_penalty(tm)
    g = torch.autograd.grad(got, tree_leaves(tm))
    _close(got.detach(), want)
    _close(g, jax.tree.leaves(want_g))

    np.testing.assert_allclose(
        float(tloss.accuracy(torch.from_numpy(logits), torch.from_numpy(y))),
        float(jloss.accuracy(jnp.asarray(logits), jnp.asarray(y))))


def test_lenet_masks_match_reference():
    """Mask init, per-scalar application, client gather/scatter,
    binarize and sparsity against ``repro.core.masks``."""
    jc, tc = _cfgs(**SMALL)
    C = 4
    _close(tmasks.init_lenet_unit_masks(tc, C, device="cpu"),
           jmasks.init_lenet_unit_masks(jc, C), tol=0)
    sp = _np(jlenet.init_server_params(jc, jax.random.PRNGKey(2)))
    scal = jax.tree.map(
        lambda p: RNG.uniform(-0.2, 1.0, size=(C,) + p.shape
                              ).astype(np.float32), sp)
    tsp, tscal = from_numpy(sp, "cpu"), from_numpy(scal, "cpu")
    _close(tmasks.init_scalar_masks(tsp, C),
           jmasks.init_scalar_masks(jax.tree.map(jnp.asarray, sp), C), tol=0)
    idx = np.array([3, 1])
    jsel = jmasks.gather_clients(jax.tree.map(jnp.asarray, scal),
                                 jnp.asarray(idx))
    tsel = tmasks.gather_clients(tscal, torch.from_numpy(idx))
    _close(tsel, jsel, tol=0)
    _close(tmasks.apply_scalar_masks(tsp, tsel),
           jmasks.apply_scalar_masks(jax.tree.map(jnp.asarray, sp), jsel),
           tol=0)
    new = jax.tree.map(lambda l: l[:2] * 0 + 7.0, scal)
    _close(tmasks.scatter_clients(tscal, torch.from_numpy(idx),
                                  from_numpy(new, "cpu")),
           jmasks.scatter_clients(jax.tree.map(jnp.asarray, scal),
                                  jnp.asarray(idx),
                                  jax.tree.map(jnp.asarray, new)), tol=0)
    _close(tmasks.binarize(tscal, 0.1),
           jmasks.binarize(jax.tree.map(jnp.asarray, scal), 0.1), tol=0)
    assert tmasks.sparsity(tscal, 0.1) == jmasks.sparsity(
        jax.tree.map(jnp.asarray, scal), 0.1)
