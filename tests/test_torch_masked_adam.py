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


# --- the multi-tensor launch: plain versions, planner, CPU paths --------

def _parent_masked_adam_plain(p, g, mu, nu, mask, *, lr, b1, b2, eps, b1t,
                              b2t):
    """``masked_adam_plain`` as the port had it before the multi-tensor
    kernel, verbatim: the CPU path must stay bit-for-bit this."""
    rows = lambda t, c: c.reshape(c.shape + (1,) * (t.ndim - c.ndim))
    g = g.to(torch.float32)
    if mask is not None:
        g = g * mask.to(torch.float32)
    mu = b1 * mu + (1 - b1) * g
    nu = b2 * nu + (1 - b2) * g * g
    mhat = mu / rows(mu, b1t)
    nhat = nu / rows(nu, b2t)
    new_p = p.to(torch.float32) - lr * mhat / (torch.sqrt(nhat) + eps)
    return new_p.to(p.dtype), mu, nu


def _parent_adam_update(params, grads, state, *, lr, b1=0.9, b2=0.999,
                        eps=1e-8):
    """``optim.adam.adam_update`` as the port had it before the
    multi-tensor kernel, verbatim."""
    step = state["step"] + 1
    stepf = step.to(torch.float32)
    b1t = 1.0 - torch.pow(b1, stepf)
    b2t = 1.0 - torch.pow(b2, stepf)

    def rows(c, p):
        return c.reshape(c.shape + (1,) * (p.ndim - c.ndim))

    def upd(p, g, mu, nu):
        g = g.to(torch.float32)
        mu = b1 * mu + (1 - b1) * g
        nu = b2 * nu + (1 - b2) * g * g
        mhat = mu / rows(b1t, mu)
        nhat = nu / rows(b2t, nu)
        delta = mhat / (torch.sqrt(nhat) + eps)
        return (p.to(torch.float32) - lr * delta).to(p.dtype), mu, nu

    with torch.no_grad():
        out = [upd(p, g, m, n) for p, g, m, n in zip(
            tree_leaves(params), tree_leaves(grads), tree_leaves(state["mu"]),
            tree_leaves(state["nu"]))]
    return [o[i] for o in out for i in range(3)], step


def _stacked_leaves(S, masked, seed):
    """(p, g, mu, nu, mask) of stacked (S, ...) leaves: mask rows of 6
    and 120 floats, a conv leaf, a (S,) leaf and an empty one."""
    rng = np.random.default_rng(seed)
    out = []
    for shape in [(S, 6), (S, 120), (S, 5, 5, 3), (S,), (S, 0)]:
        d = {k: torch.from_numpy(v) for k, v in _leaf(shape).items()}
        out.append((d["p"], d["g"], d["mu"], d["nu"],
                    d["mask"] if masked else None))
    rng.shuffle(out)
    return out


def _equal(got, want):
    for a, b in zip(got, want):
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("step", ["scalar", "per_row"])
@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("order", ["masked", "client"])
def test_multi_plain_equals_per_leaf_plain(step, masked, order):
    """The multi-tensor plain version is the per-leaf plain versions,
    bit-for-bit (tolerance 0), and the CPU path of ``adam_multi`` is it;
    nothing launches."""
    S = 4
    st = torch.tensor([3, 1, 9, 2], dtype=torch.int32) if step == "per_row" \
        else torch.tensor(5, dtype=torch.int32)
    b1t, b2t = tma.bias_corrections(st, 0.9, 0.999)
    kw = dict(KW, b1t=b1t, b2t=b2t)
    leaves = _stacked_leaves(S, masked and order == "masked", seed=7)
    client = order == "client"
    if client:
        want = [tma.adam_leaf_plain(p, g, mu, nu, **kw)
                for p, g, mu, nu, _ in leaves]
    else:
        want = [tma.masked_adam_plain(*leaf, **kw) for leaf in leaves]
        _equal(want, [_parent_masked_adam_plain(*leaf, **kw)
                      for leaf in leaves])
    tma.reset_launches()
    _equal(tma.adam_multi_plain(leaves, client_order=client, **kw), want)
    _equal(tma.adam_multi(leaves, client_order=client, **kw), want)
    assert tma.LAUNCHES == {"masked_adam": 0, "client_adam": 0}


@pytest.mark.parametrize("per_row", [False, True], ids=["scalar", "per_row"])
def test_cpu_adam_paths_bit_equal_to_parent(per_row):
    """On the CPU ``adam_update`` and ``fused_adam_update`` give the
    outputs of the port's code before the multi-tensor kernel, bit for
    bit (tolerance 0), on a stacked tree with per-row or one step."""
    S = 3
    tree = {"a": RNG.normal(size=(S, 7)).astype(np.float32),
            "b": [RNG.normal(size=(S, 4, 5)).astype(np.float32),
                  RNG.normal(size=(S,)).astype(np.float32)]}
    grads = jax.tree.map(
        lambda a: (RNG.normal(size=a.shape) * 1e-2).astype(np.float32), tree)
    st = _state(tree, [0, 4, 9] if per_row else 6)
    tp, tg, ts = (from_numpy(t, "cpu") for t in (tree, grads, st))
    flat, step = _parent_adam_update(tp, tg, ts, lr=1e-3)
    got_p, got_s = tadam.adam_update(tp, tg, ts, lr=1e-3)
    got = [t for trip in zip(tree_leaves(got_p), tree_leaves(got_s["mu"]),
                             tree_leaves(got_s["nu"])) for t in trip]
    assert all(torch.equal(a, b) for a, b in zip(got, flat))
    assert torch.equal(got_s["step"], step)
    b1t, b2t = tma.bias_corrections(ts["step"] + 1, 0.9, 0.999)
    want = [_parent_masked_adam_plain(p, g, m, n, None, lr=1e-3, b1=0.9,
                                      b2=0.999, eps=1e-8, b1t=b1t, b2t=b2t)
            for p, g, m, n in zip(*(tree_leaves(t) for t in (
                tp, tg, ts["mu"], ts["nu"])))]
    got_p, got_s = tma.fused_adam_update(tp, tg, ts, lr=1e-3)
    _equal(zip(tree_leaves(got_p), tree_leaves(got_s["mu"]),
               tree_leaves(got_s["nu"])), want)


def test_plan_launches_covers_every_leaf_once():
    """The leaf-table planner: every non-empty leaf in exactly one launch,
    its blocks the running sum of ceil(n / chunk) from 0 in that launch,
    at most ``max_leaves`` leaves a launch, empty leaves in none."""
    sizes = [0, 1, 4096, 4097, 6, 0, 196608 * 32, 120 * 19, 0] + [3] * 40
    for max_leaves in (1, 5, tma.MAX_LEAVES):
        plans = tma.plan_launches(sizes, max_leaves=max_leaves)
        seen = []
        for entries, blocks in plans:
            assert 0 < len(entries) <= max_leaves
            first = 0
            for i, b0 in entries:
                assert b0 == first
                first += -(-sizes[i] // tma.CHUNK)
            assert blocks == first
            seen += [i for i, _ in entries]
        assert seen == [i for i, n in enumerate(sizes) if n]
        n_leaves = len(seen)
        assert len(plans) == -(-n_leaves // max_leaves)
    assert tma.plan_launches([0, 0]) == []
    assert tma.plan_launches([10, 0, 5000], chunk=4096) == [
        ([(0, 0), (2, 1)], 3)]


def test_multi_cuda_wrapper_refuses_cpu_leaves():
    d = {k: torch.from_numpy(v) for k, v in _leaf((5, 3)).items()}
    b1t, b2t = tma.bias_corrections(torch.tensor(2), 0.9, 0.999)
    tma.reset_launches()
    leaf = (d["p"], d["g"], d["mu"], d["nu"], None)
    with pytest.raises(ValueError):
        tma.adam_multi_cuda([leaf], b1t=b1t, b2t=b2t, client_order=True,
                            **KW)
    # a call whose first leaf is on the CPU but not every leaf: no plain
    # version for the others, the kernel's checks refuse the call
    other = tuple(t.to("meta") for t in leaf[:4]) + (None,)
    with pytest.raises(ValueError):
        tma.adam_multi([leaf, other], b1t=b1t, b2t=b2t, **KW)
    assert tma.LAUNCHES == {"masked_adam": 0, "client_adam": 0}
