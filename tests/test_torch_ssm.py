"""Port parity: the Mamba2 block of ``repro_torch.models.ssm`` against the
JAX package's ``repro.models.ssm``, on numpy draws from a seed.

The block runs at ``mamba2-370m``'s ``reduced()`` widths (d_model 256,
d_inner 512, 16 heads of 32, state 16, one group, conv 4) and the scan
itself at 8 heads of 16 over 2 groups (so the group repeat shows).
Tolerances, float32 throughout.  ``_segsum`` and the conv: the same
f32 ops in the same order, to 1e-6 of the largest magnitude.  The scan:
the port computes the same terms in other summation orders (pairwise
products, the chunk states at once, the carry 64 chunks a product: L =
150 at chunk 1 takes three such blocks), and ``exp`` of a segment sum of up
to a whole chunk magnifies a cumsum's f32 rounding, so outputs and
states are held to 1e-5 of their largest magnitude (2e-6 seen at a
64-chunk).  The block (projections of width <= 1,200, the scan, the
gated norm) to 1e-5 of its largest output, its state and conv tail to
1e-5 of theirs.  The reference's own consistency bounds (chunk
invariance 2e-4, prefill state vs decode replay 2e-2) are kept for the
port's own paths, where the port must also hold the reference's
results at 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.models import ssm as jssm
from repro_torch.configs.base import get_config
from repro_torch.models import ssm as tssm

TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The tensors here are small: torch's intra-op threads would only
    contend with each other (and with other processes) on a CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, tol=TOL):
    want = np.asarray(want, np.float32)
    got = got.detach().to(torch.float32).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-30))


def _cfgs(**kw):
    return (dataclasses.replace(jget_config("mamba2-370m").reduced(),
                                dtype="float32", **kw),
            dataclasses.replace(get_config("mamba2-370m").reduced(),
                                dtype="float32", **kw))


@pytest.fixture(scope="module")
def block():
    """(jax cfg, torch cfg, jax params, torch params): the reference's
    init, with the conv bias, D and dt_bias redrawn so that every term
    shows."""
    jcfg, tcfg = _cfgs()
    rng = np.random.default_rng(0)
    p = {k: np.array(v) for k, v in
         jssm.mamba_init(jax.random.PRNGKey(0), jcfg).items()}
    for k in ("conv_b", "D", "dt_bias"):
        p[k] = rng.normal(0, 0.5, p[k].shape).astype(np.float32)
    p["norm_scale"] = rng.uniform(0.5, 1.5, p["norm_scale"].shape).astype(
        np.float32)
    return (jcfg, tcfg, {k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(v) for k, v in p.items()})


def _x(cfg, B, L, seed=1, scale=1.0):
    return np.random.default_rng(seed).normal(
        0, scale, (B, L, cfg.d_model)).astype(np.float32)


def test_config_ssm_fields_match_reference():
    jcfg, tcfg = jget_config("mamba2-370m"), get_config("mamba2-370m")
    for c in (lambda g: g, lambda g: g.reduced()):
        j, t = c(jcfg), c(tcfg)
        assert (t.d_inner, t.ssm_nheads, t.ssm_chunk, t.ssm_state,
                t.ssm_headdim, tssm._conv_dim(t)) == \
            (j.d_inner, j.ssm_nheads, j.ssm_chunk, j.ssm_state,
             j.ssm_headdim, jssm._conv_dim(j))


@pytest.mark.parametrize("L", [1, 7, 32])
def test_segsum_matches_reference_and_masks_before_exp(L):
    a = -np.random.default_rng(L).exponential(1.0, (2, 3, L)).astype(
        np.float32)
    want = np.asarray(jssm._segsum(jnp.asarray(a)))
    t = torch.from_numpy(a).requires_grad_(True)
    got = tssm._segsum(t)
    upper = ~np.tril(np.ones((L, L), bool))
    assert np.isneginf(got.detach().numpy()[..., upper]).all()
    assert np.isneginf(want[..., upper]).all()
    _close(got.masked_fill(torch.from_numpy(upper), 0),
           np.where(upper, 0, want), 1e-6)
    torch.exp(got).sum().backward()
    assert torch.isfinite(t.grad).all()


@pytest.mark.parametrize("L", [2, 9])
def test_causal_conv_matches_reference(L):
    rng = np.random.default_rng(L)
    x = rng.normal(size=(2, L, 12)).astype(np.float32)
    w = rng.normal(size=(12, 4)).astype(np.float32)
    bias = rng.normal(size=(12,)).astype(np.float32)
    want = jssm._causal_conv(*map(jnp.asarray, (x, w, bias)))
    _close(tssm._causal_conv(*map(torch.from_numpy, (x, w, bias))), want,
           1e-6)


def _scan_inputs(L, seed=2, B=2, H=8, P=16, G=2, N=16):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    x, Bm, Cm = f(B, L, H, P), f(B, L, G, N), f(B, L, G, N)
    dt = np.log1p(np.exp(f(B, L, H))).astype(np.float32)
    A = -np.exp(f(H)).astype(np.float32)
    s0 = f(B, H, P, N)
    return x, dt, A, Bm, Cm, s0


@pytest.mark.parametrize("initial", [False, True], ids=["zero", "initial"])
@pytest.mark.parametrize("L,chunk", [(64, 64), (64, 16), (12, 4), (7, 1),
                                     (150, 1)])
def test_ssd_chunked_matches_reference(L, chunk, initial):
    x, dt, A, Bm, Cm, s0 = _scan_inputs(L)
    init = s0 if initial else None
    wy, ws = jssm.ssd_chunked(*map(jnp.asarray, (x, dt, A, Bm, Cm)), chunk,
                              None if init is None else jnp.asarray(init))
    gy, gs = tssm.ssd_chunked(*map(torch.from_numpy, (x, dt, A, Bm, Cm)),
                              chunk,
                              None if init is None else torch.from_numpy(init))
    assert gy.dtype == gs.dtype == torch.float32
    _close(gy, wy)
    _close(gs, ws)


def test_ssd_chunked_refuses_a_chunk_that_does_not_divide():
    x, dt, A, Bm, Cm, _ = _scan_inputs(12)
    with pytest.raises(ValueError, match="does not divide"):
        tssm.ssd_chunked(*map(torch.from_numpy, (x, dt, A, Bm, Cm)), 5)


@pytest.mark.parametrize("L", [64, 48, 21])
def test_chunk_rule_matches_reference(L):
    _, tcfg = _cfgs()
    chunk = min(tcfg.ssm_chunk, L)
    while L % chunk:
        chunk //= 2
    assert tssm.chunk_size(tcfg, L) == chunk


@pytest.mark.parametrize("gate", ["none", "units", "per-example"])
@pytest.mark.parametrize("L", [48, 21])
def test_mamba_forward_matches_reference(block, gate, L):
    """Output and the returned decode cache; a (d_inner,) gate or a
    per-example (B, 1, d_inner) gate; L = 21 takes chunk 1 (21 is odd)."""
    jcfg, tcfg, jp, tp = block
    x = _x(jcfg, 2, L)
    g = None
    rng = np.random.default_rng(4)
    if gate == "units":
        g = (rng.random(jcfg.d_inner) > 0.3).astype(np.float32)
    elif gate == "per-example":
        g = (rng.random((2, 1, jcfg.d_inner)) > 0.3).astype(np.float32)
    want, wst = jssm.mamba_forward(
        jp, jnp.asarray(x), jcfg,
        unit_gate=None if g is None else jnp.asarray(g), return_state=True)
    got, gst = tssm.mamba_forward(
        tp, torch.from_numpy(x), tcfg,
        unit_gate=None if g is None else torch.from_numpy(g),
        return_state=True)
    _close(got, want)
    _close(gst["state"], wst["state"])
    _close(gst["conv"], wst["conv"])
    plain = tssm.mamba_forward(tp, torch.from_numpy(x), tcfg,
                               unit_gate=None if g is None
                               else torch.from_numpy(g))
    assert torch.equal(plain, got)


def test_mamba_forward_refuses_a_prompt_shorter_than_the_conv_tail(block):
    _, tcfg, _, tp = block
    x = torch.from_numpy(_x(tcfg, 1, 2))
    tssm.mamba_forward(tp, x, tcfg)            # no cache asked: it runs
    with pytest.raises(ValueError, match="shorter than the conv window"):
        tssm.mamba_forward(tp, x, tcfg, return_state=True)


@pytest.mark.parametrize("gate", ["none", "units"])
def test_mamba_decode_matches_reference(block, gate):
    """Three decode steps from the reference's own prefill cache, the
    cache updated in place."""
    jcfg, tcfg, jp, tp = block
    x = _x(jcfg, 2, 16)
    g = None if gate == "none" else \
        (np.random.default_rng(5).random(jcfg.d_inner) > 0.3).astype(
            np.float32)
    _, jc = jssm.mamba_forward(jp, jnp.asarray(x), jcfg, return_state=True)
    tc = {k: torch.from_numpy(np.array(v)) for k, v in jc.items()}
    steps = _x(jcfg, 2, 3, seed=6)
    for t in range(3):
        tok = steps[:, t:t + 1]
        want, jc = jssm.mamba_decode(
            jp, jnp.asarray(tok), jc, jcfg,
            unit_gate=None if g is None else jnp.asarray(g))
        state = tc["state"]
        got, tc2 = tssm.mamba_decode(
            tp, torch.from_numpy(tok), tc, tcfg,
            unit_gate=None if g is None else torch.from_numpy(g))
        assert tc2 is tc and tc["state"] is state   # in place
        _close(got, want)
        _close(tc["state"], jc["state"])
        _close(tc["conv"], jc["conv"])


def test_mamba_decode_per_example_gate_meets_its_own_row(block):
    """A (B, 1, d_inner) gate in decode gates each example by its own
    row: the step equals each row's step under its own (d_inner,) gate.
    (The reference's decode broadcasts such a gate against a (B, d_inner)
    activation into (B, B, d_inner), so it has no counterpart here.)"""
    _, tcfg, _, tp = block
    x = torch.from_numpy(_x(tcfg, 2, 8))
    tok = torch.from_numpy(_x(tcfg, 2, 1, seed=7))
    g = torch.from_numpy((np.random.default_rng(8).random(
        (2, 1, tcfg.d_inner)) > 0.3).astype(np.float32))
    _, c = tssm.mamba_forward(tp, x, tcfg, return_state=True)
    both, _ = tssm.mamba_decode(tp, tok, {k: v.clone() for k, v in c.items()},
                                tcfg, unit_gate=g)
    assert both.shape == (2, 1, tcfg.d_model)
    for i in range(2):
        one, _ = tssm.mamba_decode(
            tp, tok[i:i + 1], {k: v[i:i + 1].clone() for k, v in c.items()},
            tcfg, unit_gate=g[i, 0])
        _close(both[i:i + 1], one.detach().numpy(), 1e-6)


def test_mamba_chunked_invariant_to_chunk_size(block):
    """The reference's ``test_mamba_chunked_invariant_to_chunk_size``
    (chunks 8, 16, 32 agree to 2e-4) on the port, each chunk also held
    to the reference at that chunk."""
    jcfg, tcfg, jp, tp = block
    x = np.random.default_rng(0).normal(0, 0.3, (2, 64, jcfg.d_model)) \
        .astype(np.float32)
    outs = []
    for chunk in (8, 16, 32):
        jc = dataclasses.replace(jcfg, ssm_chunk=chunk)
        tc = dataclasses.replace(tcfg, ssm_chunk=chunk)
        got = tssm.mamba_forward(tp, torch.from_numpy(x), tc)
        _close(got, jssm.mamba_forward(jp, jnp.asarray(x), jc))
        outs.append(got.numpy())
    np.testing.assert_allclose(outs[0], outs[1], rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(outs[0], outs[2], rtol=2e-4, atol=2e-4)


def test_prefill_state_equals_decode_replay(block):
    """The reference's ``test_mamba_prefill_state_equals_decode_replay``
    on the port: the chunked forward's outputs and final state against
    the token-by-token recurrence from an empty cache (2e-2)."""
    _, tcfg, _, tp = block
    B, L = 2, 32
    x = torch.from_numpy(np.random.default_rng(0).normal(
        0, 0.3, (B, L, tcfg.d_model)).astype(np.float32))
    full, st = tssm.mamba_forward(tp, x, tcfg, return_state=True)
    cache = tssm.init_ssm_cache(tcfg, B, torch.float32, device="cpu")
    outs = [tssm.mamba_decode(tp, x[:, t:t + 1], cache, tcfg)[0]
            for t in range(L)]
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(),
                               rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(cache["state"].numpy(), st["state"].numpy(),
                               rtol=2e-2, atol=2e-2)
    np.testing.assert_array_equal(cache["conv"].numpy(), st["conv"].numpy())


def test_init_matches_reference_shapes(block):
    jcfg, tcfg, _, _ = block
    jp = jssm.mamba_init(jax.random.PRNGKey(0), jcfg)
    gen = torch.Generator().manual_seed(0)
    own = tssm.mamba_init(gen, tcfg, lead=(3,))
    assert sorted(own) == sorted(jp)
    for k in own:
        assert tuple(own[k].shape) == (3,) + tuple(jp[k].shape), k
        assert own[k].dtype == torch.float32
    for k in ("D", "dt_bias", "norm_scale", "conv_b"):
        np.testing.assert_array_equal(own[k][1].numpy(), np.asarray(jp[k]))
    # log(1..H): torch's and XLA's f32 log may part by one ulp
    np.testing.assert_allclose(own["A_log"][1].numpy(), np.asarray(
        jp["A_log"]), rtol=2e-7)
    cache = tssm.init_ssm_cache(tcfg, 2, torch.bfloat16, device="cpu")
    want = jssm.init_ssm_cache(jcfg, 2, jnp.bfloat16)
    assert {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in cache.items()} == \
        {k: (v.shape, str(v.dtype)) for k, v in want.items()}
