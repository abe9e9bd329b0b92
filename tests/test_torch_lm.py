"""Port parity: the dense decoder-only LM stack of ``repro_torch``
(``models.layers``/``mlp``/``attention``/``transformer``/``decode``,
``core.masks``' transformer half, ``launch.steps``) against the JAX
package on ``qwen2-0.5b``'s ``reduced()`` config (2 layers, d_model 256,
4/2 heads of 64, d_ff 512, vocab 512; one client and one server layer).

The reference's own params cross over through numpy
(``weights.from_numpy``), the tokens and masks are numpy draws from a
seed, and JAX runs on the CPU as its own tests run it.

Tolerances.  float32 config (``dataclasses.replace(cfg,
dtype="float32")``, all params float32): both packages do the same f32
math in other summation orders, so logits agree to 1e-4 of their
largest magnitude and caches to 1e-5 absolute.  bfloat16 config (the
default; mixed-dtype params): the same tokens go into both (teacher
forcing) and every bf16 rounding of an activation may land on the other
side of a tie, so logits are held to 2e-2 of their largest magnitude
(a few bf16 steps of 2**-8) and bf16 caches to 2e-2 absolute plus 2e-2
of each value (a K or V entry is a bf16 projection of bf16 activations
that may each have rounded one step apart: up to ~3 steps of 2**-7)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.core import masks as jmasks
from repro.launch.steps import init_serve_params as jinit_serve_params
from repro.models import decode as jdec
from repro.models import transformer as jtfm
from repro_torch.configs.base import get_config
from repro_torch.core import masks as tmasks
from repro_torch.kernels import flash_attention as tfa
from repro_torch.launch.steps import init_serve_params
from repro_torch.models import decode as tdec
from repro_torch.models import transformer as ttfm
from repro_torch.weights import from_numpy, to_numpy, tree_leaves

B, S, N_CLIENTS = 3, 12, 3
TOL = {"float32": (1e-4, 1e-5), "bfloat16": (2e-2, 2e-2)}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def model(request):
    """(dtype, jax cfg, torch cfg, jax params, torch params, jax masks,
    torch masks) for one compute dtype."""
    dtype = request.param
    jcfg = dataclasses.replace(jget_config("qwen2-0.5b").reduced(),
                               dtype=dtype)
    tcfg = dataclasses.replace(get_config("qwen2-0.5b").reduced(),
                               dtype=dtype)
    jp = jinit_serve_params(jcfg, jax.random.PRNGKey(0), dtype=dtype)
    tp = from_numpy(_np_tree(jp), "cpu")
    rng = np.random.default_rng(9)
    jm = jax.tree.map(lambda m: jnp.asarray(
        (rng.random(m.shape) > 0.4).astype(np.float32)),
        jmasks.init_unit_masks(jcfg, N_CLIENTS))
    tm = from_numpy(_np_tree(jm), "cpu")
    return dtype, jcfg, tcfg, jp, tp, jm, tm


def _tokens(cfg, seed=0, shape=(B, S)):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _close_logits(got, want, dtype):
    """Within ``rel`` of the largest magnitude (reduced vocab = padded
    vocab, so no -1e9 pad column enters the scale)."""
    rel, _ = TOL[dtype]
    got = got.to(torch.float32).numpy()
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max())


def _close_caches(got, want, dtype):
    _, atol = TOL[dtype]
    g, w = tree_leaves(to_numpy(got)), jax.tree.leaves(_np_tree(want))
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, np.asarray(b, np.float32),
                                   rtol=0 if dtype == "float32" else atol,
                                   atol=atol)


def test_config_matches_reference():
    for reduce in (False, True):
        j, t = jget_config("qwen2-0.5b"), get_config("qwen2-0.5b")
        if reduce:
            j, t = j.reduced(), t.reduced()
        for f in dataclasses.fields(t):
            assert getattr(t, f.name) == getattr(j, f.name), f.name
        assert (t.split_layer, t.padded_vocab()) == \
            (j.split_layer, j.padded_vocab())
        assert jtfm.model_plan(j)["server_segments"] == [
            jtfm.Segment(s.n_rep, tuple(jtfm.LayerDesc(**vars(d))
                                        for d in s.body))
            for s in ttfm.model_plan(t)["server_segments"]]


def test_layer_primitives():
    """RMS norm (f32 inside, cast back), split-halves RoPE, the padded
    vocabulary's logit bias and the f32 unembed, at qwen2's theta and
    full vocabulary."""
    from repro.models import layers as jl
    from repro_torch.models import layers as tl
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, 5, 3, 64)).astype(np.float32)
    pos = rng.integers(0, 4096, (2, 5)).astype(np.int32)
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        xt = torch.from_numpy(x).to(dt)
        xj = jnp.asarray(xt.to(torch.float32).numpy()).astype(jdt)
        got = tl.apply_rope(xt, torch.from_numpy(pos), 1e6)
        want = jl.apply_rope(xj, jnp.asarray(pos), 1e6)
        tol = 1e-5 if dt == torch.float32 else 2 ** -7
        np.testing.assert_allclose(got.to(torch.float32).numpy(),
                                   np.asarray(want, np.float32), rtol=tol,
                                   atol=tol)
        scale = rng.normal(size=(64,)).astype(np.float32)
        got = tl.apply_norm({"scale": torch.from_numpy(scale)}, xt, "rms")
        want = jl.apply_norm({"scale": jnp.asarray(scale)}, xj, "rms")
        assert got.dtype == dt
        np.testing.assert_allclose(got.to(torch.float32).numpy(),
                                   np.asarray(want, np.float32), rtol=tol,
                                   atol=tol)
    np.testing.assert_array_equal(tl.vocab_pad_bias(151_936, 152_064).numpy(),
                                  np.asarray(jl.vocab_pad_bias(151_936,
                                                               152_064)))
    table = rng.normal(size=(40, 64)).astype(np.float32)
    np.testing.assert_allclose(
        tl.unembed({"table": torch.from_numpy(table).to(torch.bfloat16)},
                   torch.from_numpy(x[0, 0])).numpy(),
        np.asarray(jl.unembed({"table": jnp.asarray(table).astype(
            jnp.bfloat16)}, jnp.asarray(x[0, 0]))), rtol=1e-5, atol=1e-5)


def test_serve_params_have_the_reference_structure_and_dtypes(model):
    """The port's own init: same tree, shapes and per-leaf dtypes as the
    reference's (bf16 only for >= 2-dim leaves of >= 65,536 elements),
    and an untied server-owned LM head."""
    dtype, jcfg, tcfg, jp, tp, _, _ = model
    mine = init_serve_params(tcfg, 0, dtype, device="cpu")
    j = jax.tree.leaves(jp)
    t = tree_leaves(mine)
    assert [tuple(a.shape) for a in j] == [tuple(a.shape) for a in t]
    assert [str(a.dtype) for a in j] == \
        [str(a.dtype).replace("torch.", "") for a in t]
    assert tuple(mine["server"]["lm_head"]["table"].shape) == \
        (tcfg.padded_vocab(), tcfg.d_model)
    assert not torch.equal(mine["server"]["lm_head"]["table"],
                           mine["client"]["embed"]["table"])
    if dtype == "bfloat16":
        assert {str(a.dtype) for a in j} == {"float32", "bfloat16"}


@pytest.mark.parametrize("ragged", [False, True], ids=["equal", "ragged"])
def test_prefill_logits_and_caches(model, ragged):
    dtype, jcfg, tcfg, jp, tp, _, _ = model
    toks = _tokens(jcfg, 1)
    last = np.array([S - 1, 4, 8], np.int32) if ragged else None
    want, wcache = jdec.prefill(
        jcfg, jp, jnp.asarray(toks), cache_len=S + 4,
        last_index=None if last is None else jnp.asarray(last))
    tfa.reset_launches()
    got, gcache = tdec.prefill(
        tcfg, tp, torch.from_numpy(toks), cache_len=S + 4,
        last_index=None if last is None else torch.from_numpy(last))
    assert tfa.LAUNCHES["flash_attention"] == 0      # CPU: plain version
    assert got.shape == (B, 1, tcfg.padded_vocab())
    _close_logits(got, want, dtype)
    _close_caches(gcache, wcache, dtype)


@pytest.mark.parametrize("pos_kind", ["scalar", "per_slot"])
def test_decode_step_teacher_forced(model, pos_kind):
    """Two decode steps from the reference's own prefill cache, fed the
    same tokens on both sides."""
    dtype, jcfg, tcfg, jp, tp, _, _ = model
    toks = _tokens(jcfg, 2)
    lens = np.array([S, 5, 9], np.int32) if pos_kind == "per_slot" else \
        np.full(B, S, np.int32)
    last = jnp.asarray(lens - 1) if pos_kind == "per_slot" else None
    _, jcache = jdec.prefill(jcfg, jp, jnp.asarray(toks), cache_len=S + 4,
                             last_index=last)
    tcache = from_numpy(_np_tree(jcache), "cpu")
    nxt = _tokens(jcfg, 3, (2, B, 1))
    for t in range(2):
        if pos_kind == "scalar":
            jpos, tpos = jnp.asarray(S + t, jnp.int32), S + t
        else:
            jpos, tpos = jnp.asarray(lens + t), torch.from_numpy(lens + t)
        want, jcache = jdec.decode_step(jcfg, jp, jnp.asarray(nxt[t]),
                                        jcache, jpos)
        got, tcache = tdec.decode_step(tcfg, tp, torch.from_numpy(nxt[t]),
                                       tcache, tpos)
        _close_logits(got, want, dtype)
        _close_caches(tcache, jcache, dtype)


def test_windowed_ring_prefill_and_decode(model):
    """window < S: the prefill cache is the ring of the last `window`
    positions; decode writes around the ring (scalar and per-slot)."""
    dtype, jcfg, tcfg, jp, tp, _, _ = model
    window, toks = 8, _tokens(jcfg, 4)
    want, jcache = jdec.prefill(jcfg, jp, jnp.asarray(toks), window=window)
    got, tcache = tdec.prefill(tcfg, tp, torch.from_numpy(toks),
                               window=window)
    _close_logits(got, want, dtype)
    _close_caches(tcache, jcache, dtype)
    nxt = _tokens(jcfg, 5, (2, B, 1))
    for t, per_slot in ((0, False), (1, True)):
        pos = np.full(B, S + t, np.int32)
        jpos = jnp.asarray(pos) if per_slot else jnp.asarray(S + t, jnp.int32)
        tpos = torch.from_numpy(pos) if per_slot else S + t
        want, jcache = jdec.decode_step(jcfg, jp, jnp.asarray(nxt[t]),
                                        jcache, jpos, window=window)
        got, tcache = tdec.decode_step(tcfg, tp, torch.from_numpy(nxt[t]),
                                       tcache, tpos, window=window)
        _close_logits(got, want, dtype)
        _close_caches(tcache, jcache, dtype)


@pytest.mark.parametrize("kind", ["per_client", "per_example"])
def test_gated_prefill_and_decode(model, kind):
    dtype, jcfg, tcfg, jp, tp, jm, tm = model
    clients = [2, 0, 2]
    if kind == "per_client":
        jg, tg = jmasks.gates_for_client(jm, 1), tmasks.gates_for_client(tm, 1)
    else:
        jg = jmasks.expand_gates(jm, jnp.asarray(clients))
        tg = tmasks.expand_gates(tm, clients)
        stacked = tmasks.stack_client_gates(
            [tmasks.gates_for_client(tm, c) for c in clients])
        for a, b in zip(tree_leaves(tg), tree_leaves(stacked)):
            assert torch.equal(a, b)
    for a, b in zip(tree_leaves(to_numpy(tg)), jax.tree.leaves(jg)):
        np.testing.assert_array_equal(a, np.asarray(b))
    toks = _tokens(jcfg, 6)
    want, jcache = jdec.prefill(jcfg, jp, jnp.asarray(toks), gates=jg,
                                cache_len=S + 2)
    got, tcache = tdec.prefill(tcfg, tp, torch.from_numpy(toks), gates=tg,
                               cache_len=S + 2)
    _close_logits(got, want, dtype)
    nxt = _tokens(jcfg, 7, (B, 1))
    want, _ = jdec.decode_step(jcfg, jp, jnp.asarray(nxt), jcache,
                               jnp.asarray(S, jnp.int32), gates=jg)
    got, _ = tdec.decode_step(tcfg, tp, torch.from_numpy(nxt), tcache, S,
                              gates=tg)
    _close_logits(got, want, dtype)


def test_gated_full_sequence_forward(model):
    """client_forward -> server_forward with per-example gates: logits at
    every position."""
    dtype, jcfg, tcfg, jp, tp, jm, tm = model
    clients = [1, 0, 2]
    toks = _tokens(jcfg, 8)
    acts = jtfm.client_forward(jcfg, jp["client"], jnp.asarray(toks))
    want, _ = jtfm.server_forward(jcfg, jp["server"], acts,
                                  jnp.asarray(toks),
                                  gates=jmasks.expand_gates(
                                      jm, jnp.asarray(clients)))
    tacts = ttfm.client_forward(tcfg, tp["client"], torch.from_numpy(toks))
    _close_logits(tacts, acts, dtype)
    got = ttfm.server_forward(tcfg, tp["server"], tacts,
                              torch.from_numpy(toks),
                              gates=tmasks.expand_gates(tm, clients))
    _close_logits(got, want, dtype)


def test_fold_unit_masks(model):
    dtype, jcfg, tcfg, jp, tp, jm, tm = model
    want = jmasks.fold_unit_masks(jcfg, jp["server"], jm, 2)
    got = tmasks.fold_unit_masks(tcfg, tp["server"], tm, 2)
    w, g = jax.tree.leaves(_np_tree(want)), tree_leaves(got)
    assert len(w) == len(g)
    for a, b in zip(g, w):
        assert str(a.dtype).replace("torch.", "") == str(b.dtype)
        np.testing.assert_array_equal(
            a.to(torch.float32).numpy(), np.asarray(b, np.float32))
    # only wo and w_down are copies; every other leaf is shared
    layer, orig = got["segments"][0][0], tp["server"]["segments"][0][0]
    assert layer["mixer"]["wq"] is orig["mixer"]["wq"]
    assert layer["mixer"]["wo"] is not orig["mixer"]["wo"]


def test_init_cache_then_decode_from_position_zero(model):
    """An empty cache from ``init_cache`` (the reference's layout and
    shapes), filled by decode steps from position 0, and the decoder-only
    stack qualifies for ragged / per-slot serving."""
    dtype, jcfg, tcfg, jp, tp, _, _ = model
    jcache = jdec.init_cache(jcfg, B, 6)
    tcache = tdec.init_cache(tcfg, B, 6, device="cpu")
    assert [a.shape for a in jax.tree.leaves(jcache)] == \
        [tuple(a.shape) for a in tree_leaves(tcache)]
    assert {str(a.dtype) for a in tree_leaves(tcache)} == \
        {"torch." + dtype}
    nxt = _tokens(jcfg, 10, (2, B, 1))
    for t in range(2):
        want, jcache = jdec.decode_step(jcfg, jp, jnp.asarray(nxt[t]),
                                        jcache, jnp.asarray(t, jnp.int32))
        got, tcache = tdec.decode_step(tcfg, tp, torch.from_numpy(nxt[t]),
                                       tcache, t)
        _close_logits(got, want, dtype)
        _close_caches(tcache, jcache, dtype)
    assert tdec.slot_serving_ok(tcfg) == jdec.slot_serving_ok(jcfg) is True
