"""Port parity: ``repro_torch.kernels.masked_adam`` and
``repro_torch.optim.adam`` against the reference's Pallas kernel (run
with ``interpret=True`` on the CPU) and its ``optim.adam.adam_update``.

Inputs are numpy arrays from a seed.  Tolerance: both sides do the same
float32 operations in the same order; only ``beta ** step`` may round
differently between XLA's and torch's ``pow`` (1 ULP in the bias
correction), which moves the update by a relative ~1e-7 — so 1e-6
relative plus 1e-9 absolute."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import masked_adam as jma
from repro.optim import adam as jadam
from repro_torch.kernels import masked_adam as tma
from repro_torch.optim import adam as tadam
from repro_torch.weights import from_numpy, to_numpy, tree_leaves

RNG = np.random.default_rng(3)
RTOL, ATOL = 1e-6, 1e-9
KW = dict(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8)


def _close(got, want):
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=RTOL,
                                   atol=ATOL)


def _leaf(shape):
    return {"p": RNG.normal(size=shape).astype(np.float32),
            "g": (RNG.normal(size=shape) * 1e-2).astype(np.float32),
            "mu": (RNG.normal(size=shape) * 1e-3).astype(np.float32),
            "nu": (RNG.random(size=shape) * 1e-4).astype(np.float32),
            "mask": RNG.random(size=shape).astype(np.float32)}


@pytest.mark.parametrize("shape", [(300,), (17, 33), (4, 5, 6), (1,)])
@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("step", [1, 7])
def test_masked_adam_matches_pallas_interpret(shape, masked, step):
    d = _leaf(shape)
    m = d["mask"] if masked else None
    want = jma.masked_adam(*(jnp.asarray(d[k]) for k in ("p", "g", "mu",
                                                          "nu")),
                           None if m is None else jnp.asarray(m),
                           step=step, interpret=True, **KW)
    got = tma.masked_adam(*(torch.from_numpy(d[k]) for k in ("p", "g", "mu",
                                                              "nu")),
                          None if m is None else torch.from_numpy(m),
                          step=step, **KW)
    _close(got, want)


def _tree():
    return {"blocks": [RNG.normal(size=(5, 5, 3, 4)).astype(np.float32),
                       RNG.normal(size=(4,)).astype(np.float32)],
            "fc": {"w": RNG.normal(size=(12, 7)).astype(np.float32)}}


def _state(tree, step):
    small = lambda a, s: (RNG.random(size=a.shape) * s).astype(np.float32)
    return {"mu": jax.tree.map(lambda a: small(a, 1e-3), tree),
            "nu": jax.tree.map(lambda a: small(a, 1e-5), tree),
            "step": np.asarray(step, np.int32)}


def test_fused_adam_update_matches_adam_update():
    params, grads = _tree(), _tree()
    st = _state(params, 4)
    want = jadam.adam_update(jax.tree.map(jnp.asarray, params),
                             jax.tree.map(jnp.asarray, grads),
                             jax.tree.map(jnp.asarray, st), lr=1e-3)
    tp, tg, ts = (from_numpy(t, "cpu") for t in (params, grads, st))
    for fn in (tma.fused_adam_update, tadam.adam_update):
        got = fn(tp, tg, ts, lr=1e-3)
        _close(to_numpy(got[0]), want[0])
        _close(to_numpy(got[1]["mu"]), want[1]["mu"])
        _close(to_numpy(got[1]["nu"]), want[1]["nu"])
        assert int(got[1]["step"]) == int(want[1]["step"]) == 5


def test_fused_adam_update_with_mask_matches_pallas():
    params, grads, mask = _tree(), _tree(), jax.tree.map(
        lambda a: (a > 0).astype(np.float32), _tree())
    st = _state(params, 0)
    want = jma.fused_adam_update(
        *(jax.tree.map(jnp.asarray, t) for t in (params, grads, st)),
        lr=1e-3, mask=jax.tree.map(jnp.asarray, mask), interpret=True)
    got = tma.fused_adam_update(
        *(from_numpy(t, "cpu") for t in (params, grads, st)), lr=1e-3,
        mask=from_numpy(mask, "cpu"))
    _close(to_numpy(got[0]), want[0])
    _close(to_numpy(got[1]), {k: want[1][k] for k in ("mu", "nu", "step")})


@pytest.mark.parametrize("fn", ["fused", "plain"])
def test_stacked_rows_with_different_steps_match_vmap(fn):
    """Stacked (S, ...) leaves whose rows sit at different steps (the
    mask-Adam state of clients selected on different iterations) against
    ``jax.vmap`` of the reference update."""
    S = 4
    masks = {"blocks": [RNG.random(size=(S, 8)).astype(np.float32)],
             "fc1": RNG.random(size=(S, 12)).astype(np.float32),
             "scalar": RNG.random(size=(S, 3, 3, 2)).astype(np.float32)}
    grads = jax.tree.map(
        lambda a: (RNG.normal(size=a.shape) * 1e-2).astype(np.float32), masks)
    st = _state(masks, [0, 3, 11, 1])
    want = jax.vmap(lambda p, g, o: jadam.adam_update(p, g, o, lr=1e-3))(
        *(jax.tree.map(jnp.asarray, t) for t in (masks, grads, st)))
    update = tma.fused_adam_update if fn == "fused" else tadam.adam_update
    got = update(*(from_numpy(t, "cpu") for t in (masks, grads, st)),
                 lr=1e-3)
    _close(to_numpy(got[0]), want[0])
    _close(to_numpy(got[1]), want[1])
    np.testing.assert_array_equal(got[1]["step"].numpy(), [1, 4, 12, 2])


def test_cpu_leaves_never_launch_and_cuda_wrapper_refuses_cpu():
    tma.reset_launches()
    d = {k: torch.from_numpy(v) for k, v in _leaf((5, 3)).items()}
    tma.masked_adam(d["p"], d["g"], d["mu"], d["nu"], d["mask"], step=2,
                    **KW)
    assert tma.LAUNCHES["masked_adam"] == 0
    b1t, b2t = tma.bias_corrections(torch.tensor(2), 0.9, 0.999)
    with pytest.raises(ValueError):
        tma.masked_adam_cuda(d["p"], d["g"], d["mu"], d["nu"], None,
                             b1t=b1t, b2t=b2t, **KW)
