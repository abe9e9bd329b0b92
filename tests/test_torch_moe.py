"""Port parity on the MoE configs: ``deepseek-moe-16b`` (64 routed experts
top-6, 2 shared, a dense first layer) and ``qwen3-moe-30b-a3b`` (128
experts top-8, GQA 32/4), against the JAX package.

The configs are compared at full size and ``reduced()``.  The model runs
at ``reduced()`` (d_model 256, 4 heads, 4 experts top-2, moe_d_ff 128,
deepseek with 1 shared expert), deepseek at ``replace(reduced(),
first_k_dense=1, n_layers=3)`` so that its dense prefix (the client's
layer 0) and an MoE segment of two layers (the server's) both show.
The reference's params cross over through numpy
(``weights.from_numpy``); activations, tokens and masks are numpy draws
from a seed, and JAX runs on the CPU as its own tests run it.

Tolerances.  ``moe_forward`` in float32: the same f32 math in other
summation orders (the router, the three expert products, the K-sum), so
within 1e-5 of the largest output magnitude; the aux loss (a mean of
products of f32 softmax values) within 1e-6.  In bfloat16 every product
is rounded to bf16 on both sides and torch and XLA accumulate and round
in their own orders, so outputs are held to 2e-2 of the largest
magnitude (a few bf16 steps of 2**-8) -- ``tests/test_torch_lm.py``'s
bound for the whole stack; the routing itself (expert indices and the
keep mask) must be EQUAL, since a routing flip would move a token's
output by a whole expert's contribution.  The stack's logits take
``tests/test_torch_lm.py``'s ``TOL`` for the same reasons, its f32
caches too; its bf16 caches are held to 2e-2 of each leaf's largest
magnitude (``_close_caches``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.core import accounting as jacc
from repro.core import masks as jmasks
from repro.launch.steps import init_serve_params as jinit_serve_params
from repro.models import decode as jdec
from repro.models import moe as jmoe
from repro.models import transformer as jtfm
from repro_torch.configs.base import get_config
from repro_torch.core import accounting as tacc
from repro_torch.core import masks as tmasks
from repro_torch.launch.steps import init_serve_params
from repro_torch.models import decode as tdec
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttfm
from repro_torch.weights import from_numpy, to_numpy, tree_leaves, tree_map

ARCHS = ("deepseek-moe-16b", "qwen3-moe-30b-a3b")
B, S, N_CLIENTS = 3, 12, 3
TOL = {"float32": (1e-4, 1e-5), "bfloat16": (2e-2, 2e-2)}
MOE_TOL = {"float32": 1e-5, "bfloat16": 2e-2}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The tensors here are small: torch's intra-op threads would only
    contend with each other (and with other processes) on this box."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _small(get, arch, dtype="float32", **kw):
    """The tests' config: ``reduced()``, deepseek with its dense first
    layer and three layers."""
    cfg = get(arch).reduced()
    if arch == "deepseek-moe-16b":
        cfg = dataclasses.replace(cfg, first_k_dense=1, n_layers=3)
    return dataclasses.replace(cfg, dtype=dtype, **kw)


def _plan(plan):
    return [tuple((d.mixer, d.ffn, d.cross, d.causal) for d in s.body)
            + (s.n_rep,) for s in plan]


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("size", ["full", "reduced", "small"])
def test_config_matches_reference(arch, size):
    """Every field, the split, the parameter counts, the segment plans
    and the accounting's FLOPs per token."""
    j, t = jget_config(arch), get_config(arch)
    if size == "reduced":
        j, t = j.reduced(), t.reduced()
    elif size == "small":
        j, t = _small(jget_config, arch), _small(get_config, arch)
    for f in dataclasses.fields(t):
        assert getattr(t, f.name) == getattr(j, f.name), f.name
    assert (t.split_layer, t.padded_vocab(), t.param_count(),
            t.active_param_count()) == \
        (j.split_layer, j.padded_vocab(), j.param_count(),
         j.active_param_count())
    for side in ("client_segments", "server_segments"):
        assert _plan(ttfm.model_plan(t)[side]) == \
            _plan(jtfm.model_plan(j)[side])
    for part in ("client", "server", "full"):
        assert tacc.transformer_matmul_params(t, part) == \
            jacc.transformer_matmul_params(j, part)
        assert tacc.transformer_flops_per_token(t, part, 512) == \
            jacc.transformer_flops_per_token(j, part, 512)


def test_full_size_counts_and_plans():
    ds, qw = get_config("deepseek-moe-16b"), get_config("qwen3-moe-30b-a3b")
    assert (ds.param_count(), ds.active_param_count()) == \
        (16_375_611_392, 2_828_533_760)
    assert (qw.param_count(), qw.active_param_count()) == \
        (30_531_911_680, 3_352_821_760)
    plan = ttfm.model_plan(ds)
    assert (ds.split_layer, qw.split_layer) == (6, 10)
    assert _plan(plan["client_segments"]) == [
        (("attn", "dense", False, True), 1), (("attn", "moe", False, True), 5)]
    assert _plan(plan["server_segments"]) == [
        (("attn", "moe", False, True), 22)]
    assert _plan(ttfm.model_plan(qw)["server_segments"]) == [
        (("attn", "moe", False, True), 38)]


# ---------------------------------------------------------------------------
# moe_forward
# ---------------------------------------------------------------------------


def _block(arch, dtype="float32", **kw):
    """(jax cfg, torch cfg, jax params, torch params) of one MoE block at
    the reduced width; params cast to ``dtype`` as a serving init casts
    large leaves."""
    jcfg = dataclasses.replace(jget_config(arch).reduced(), **kw)
    tcfg = dataclasses.replace(get_config(arch).reduced(), **kw)
    jp = jmoe.moe_init(jax.random.PRNGKey(0), jcfg)
    if dtype == "bfloat16":
        jp = jax.tree.map(lambda w: w.astype(jnp.bfloat16)
                          if w.size >= 1 << 16 else w, jp)
    return jcfg, tcfg, jp, from_numpy(_np_tree(jp), "cpu")


def _acts(cfg, shape, dtype, seed=0):
    x = np.random.default_rng(seed).normal(
        size=shape + (cfg.d_model,)).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.dtype(dtype))
    return jx, torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))


def _gate(kind, E, batch, seed=1):
    rng = np.random.default_rng(seed)
    if kind == "none":
        return None
    if kind == "experts":
        return rng.random(E).astype(np.float32)
    return (rng.random((batch, E)) > 0.5).astype(np.float32)


def _routing(jcfg, jp, jx):
    """The reference's expert indices and keep mask, computed with its
    own ops (``moe_forward``'s first half)."""
    B_, S_ = jx.shape[:2]
    logits = (jx @ jp["router"].astype(jx.dtype)).astype(jnp.float32)
    _, idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1),
                           jcfg.experts_per_token)
    flat = idx.reshape(B_, -1)
    onehot = jax.nn.one_hot(flat, jcfg.n_experts, dtype=jnp.int32)
    pos = jnp.take_along_axis(jnp.cumsum(onehot, axis=1) - onehot,
                              flat[..., None], axis=2)[..., 0]
    return np.asarray(idx), np.asarray(pos < jmoe._capacity(S_, jcfg))


def _check_block(jcfg, tcfg, jp, tp, jx, tx, gate, dtype):
    jg = None if gate is None else jnp.asarray(gate)
    tg = None if gate is None else torch.from_numpy(gate)
    want, jaux = jmoe.moe_forward(jp, jx, jcfg, jg)
    got, taux = tmoe.moe_forward(tp, tx, tcfg, tg)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    assert taux.dtype == torch.float32 and taux.shape == ()
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got.to(torch.float32).numpy(), want, rtol=0,
                               atol=MOE_TOL[dtype] * np.abs(want).max())
    np.testing.assert_allclose(float(taux), float(jaux), rtol=0, atol=1e-6)
    idx, keep = _routing(jcfg, jp, jx)
    _, tidx, _, _ = tmoe.route(tp, tx, tcfg)
    C = tmoe._capacity(tx.shape[1], tcfg)
    assert C == jmoe._capacity(tx.shape[1], jcfg)
    _, _, tkeep = tmoe.dispatch(tidx, C, tcfg.n_experts)
    np.testing.assert_array_equal(tidx.numpy(), idx)
    np.testing.assert_array_equal(tkeep.numpy(), keep)
    return want, keep


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shared", [0, 1], ids=["no-shared", "shared"])
@pytest.mark.parametrize("gate", ["none", "experts", "per-example"])
@pytest.mark.parametrize("seq", [1, 20], ids=["decode-S1", "S20"])
def test_moe_forward_matches_reference(dtype, shared, gate, seq):
    """Output and aux loss, with no gate, an (E,) gate or a (B, E) gate,
    with and without the shared expert, at S = 20 and at the decode
    shape S = 1; the routing (indices and keep mask) equal."""
    jcfg, tcfg, jp, tp = _block("deepseek-moe-16b", dtype,
                                n_shared_experts=shared)
    jx, tx = _acts(jcfg, (3, seq), dtype)
    _check_block(jcfg, tcfg, jp, tp, jx, tx,
                 _gate(gate, jcfg.n_experts, 3), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_forward_drops_as_the_reference(dtype):
    """``moe_capacity_factor = 0.5``: C = 8 for 40 tokens x top-2 over 4
    experts (a mean load of 20), so assignments are dropped, the same
    ones on both sides; the port's drop counter sees them."""
    jcfg, tcfg, jp, tp = _block("qwen3-moe-30b-a3b", dtype,
                                moe_capacity_factor=0.5)
    jx, tx = _acts(jcfg, (2, 40), dtype, seed=3)
    tmoe.count_drops()
    try:
        _, keep = _check_block(jcfg, tcfg, jp, tp, jx, tx, None, dtype)
        share = tmoe.drop_share()
    finally:
        tmoe.count_drops(False)
    assert not keep.all()
    assert share == pytest.approx(1 - keep.mean())
    assert tmoe.DROPS == {"on": False, "dropped": 0, "assigned": 0}


def test_solo_and_padded_rows_differ_as_the_reference():
    """The capacity follows the row's padded length: 20 tokens alone get
    C = 8 and, padded to 64, C = 16; at ``moe_capacity_factor = 0.5`` the
    reference's own outputs for the 20 tokens differ, and the port
    matches it on both."""
    jcfg, tcfg, jp, tp = _block("deepseek-moe-16b", "float32",
                                moe_capacity_factor=0.5)
    assert (tmoe._capacity(20, tcfg), tmoe._capacity(64, tcfg)) == (8, 16)
    jx, tx = _acts(jcfg, (1, 64), "float32", seed=5)
    solo, _ = _check_block(jcfg, tcfg, jp, tp, jx[:, :20], tx[:, :20], None,
                           "float32")
    padded, _ = _check_block(jcfg, tcfg, jp, tp, jx, tx, None, "float32")
    assert np.abs(solo - padded[:, :20]).max() > 1e-2


@pytest.mark.parametrize("arch", ARCHS)
def test_zeroed_router_ties_to_the_lowest_experts(arch):
    """A zero router makes every logit tie: the reference's top-k picks
    experts 0..K-1 for every token, and so must the port."""
    jcfg, tcfg, jp, tp = _block(arch)
    jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    tp = dict(tp, router=torch.zeros_like(tp["router"]))
    jx, tx = _acts(jcfg, (2, 9), "float32", seed=7)
    _check_block(jcfg, tcfg, jp, tp, jx, tx, None, "float32")
    _, idx, _, _ = tmoe.route(tp, tx, tcfg)
    K = tcfg.experts_per_token
    assert torch.equal(idx, torch.arange(K).expand(2, 9, K))


def test_top_k_lower_index_on_ties():
    p = torch.tensor([[0.1, 0.3, 0.3, 0.2, 0.3, 0.1]])
    vals, idx = tmoe.top_k_lower_index(p, 4)
    assert idx.tolist() == [[1, 2, 4, 3]]
    jv, ji = jax.lax.top_k(jnp.asarray(p.numpy()), 4)
    assert np.asarray(ji).tolist() == idx.tolist()
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


# ---------------------------------------------------------------------------
# the stack: prefill, decode, gates, fold
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module",
                params=[(a, d) for a in ARCHS
                        for d in ("float32", "bfloat16")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def model(request):
    """(dtype, jax cfg, torch cfg, jax params, torch params, jax masks,
    torch masks) for one arch and compute dtype."""
    arch, dtype = request.param
    jcfg, tcfg = _small(jget_config, arch, dtype), \
        _small(get_config, arch, dtype)
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
    rel, _ = TOL[dtype]
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.to(torch.float32).numpy(), want, rtol=0,
                               atol=rel * np.abs(want).max())


def _close_caches(got, want, dtype):
    """f32: within 1e-5 absolute.  bf16: within 2e-2 of each leaf's
    largest magnitude -- the MoE block's bf16 output sits up to two bf16
    steps from the reference's (F.silu rounds once where XLA rounds the
    sigmoid and the product; other accumulation orders in the expert
    products), and deepseek's third layer reads K/V through two such
    blocks."""
    rel, atol = TOL[dtype]
    g, w = tree_leaves(to_numpy(got)), jax.tree.leaves(_np_tree(want))
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.shape == b.shape
        b = np.asarray(b, np.float32)
        if dtype == "bfloat16":
            atol = rel * np.abs(b).max()
        np.testing.assert_allclose(a, b, rtol=0, atol=atol)


def test_param_tree_matches_reference(model):
    """The reference's MoE param tree, through ``weights.from_numpy``, has
    the port's own init's keys, shapes and dtypes: router, stacked
    experts and (deepseek) the shared experts, over ``n_rep``."""
    dtype, _, tcfg, _, tp, _, _ = model
    own = init_serve_params(tcfg, 0, dtype, device="cpu")
    assert tree_map(lambda t: None, own) == tree_map(lambda t: None, tp)
    for a, b in zip(tree_leaves(own), tree_leaves(tp)):
        assert (a.shape, a.dtype) == (b.shape, b.dtype)
    ffn = tp["server"]["segments"][-1][0]["ffn"]
    E, D, F = tcfg.n_experts, tcfg.d_model, tcfg.moe_d_ff
    assert ffn["w_gate"].shape[1:] == (E, D, F)
    assert ffn["w_down"].shape[1:] == (E, F, D)
    assert ("shared" in ffn) == bool(tcfg.n_shared_experts)


def test_expert_masks_match_reference(model):
    _, jcfg, tcfg, _, _, _, _ = model
    want = jmasks.init_unit_masks(jcfg, N_CLIENTS)
    got = tmasks.init_unit_masks(tcfg, N_CLIENTS, device="cpu")
    assert [tuple(t.shape) for t in tree_leaves(got)] == \
        [w.shape for w in jax.tree.leaves(want)]
    assert got[-1]["0"]["ffn"].shape[-1] == tcfg.n_experts


@pytest.mark.parametrize("ragged", [False, True], ids=["equal", "ragged"])
def test_prefill_logits_and_caches(model, ragged):
    dtype, jcfg, tcfg, jp, tp, _, _ = model
    toks = _tokens(jcfg, 1)
    last = np.array([S - 1, 4, 8], np.int32) if ragged else None
    want, wcache = jdec.prefill(
        jcfg, jp, jnp.asarray(toks), cache_len=S + 4,
        last_index=None if last is None else jnp.asarray(last))
    got, gcache = tdec.prefill(
        tcfg, tp, torch.from_numpy(toks), cache_len=S + 4,
        last_index=None if last is None else torch.from_numpy(last))
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


def test_gated_prefill_and_decode_per_example(model):
    """Per-example gates (three clients in one batch: heads and experts)
    through a prefill and a decode step."""
    dtype, jcfg, tcfg, jp, tp, jm, tm = model
    clients = [2, 0, 2]
    jg = jmasks.expand_gates(jm, jnp.asarray(clients))
    tg = tmasks.expand_gates(tm, clients)
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


def test_fold_unit_masks(model):
    """Folding a client's masks (heads into ``wo``, experts into their
    whole ``w_down``) bit for bit as the reference folds them."""
    dtype, jcfg, tcfg, jp, tp, jm, tm = model
    want = jmasks.fold_unit_masks(jcfg, jp["server"], jm, 2)
    got = tmasks.fold_unit_masks(tcfg, tp["server"], tm, 2)
    w, g = jax.tree.leaves(_np_tree(want)), tree_leaves(got)
    assert len(w) == len(g)
    for a, b in zip(g, w):
        assert str(a.dtype).replace("torch.", "") == str(b.dtype)
        np.testing.assert_array_equal(
            a.to(torch.float32).numpy(), np.asarray(b, np.float32))


def test_fold_equals_gated_forward(model):
    """The server stack with a client's binary gates equals the stack
    through its folded weights (the reference's
    ``tests/test_masks.py::test_fold_equals_gated_forward``, at its
    tolerance in bf16 and at f32 rounding in f32)."""
    dtype, _, tcfg, _, tp, _, tm = model
    toks = torch.from_numpy(_tokens(tcfg, 8, (2, 16)))
    acts = ttfm.client_forward(tcfg, tp["client"], toks)
    gates = tmasks.gates_for_client(tm, 1)
    gated = ttfm.server_forward(tcfg, tp["server"], acts, toks, gates=gates)
    folded = ttfm.server_forward(
        tcfg, tmasks.fold_unit_masks(tcfg, tp["server"], tm, 1), acts, toks)
    tol = 5e-2 if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(gated.numpy(), folded.numpy(), rtol=tol,
                               atol=tol)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_init_draws_expert_rows_as_the_whole_tree(arch):
    """The serving init draws each stacked expert leaf one ``n_rep`` row
    at a time into its cast stack: the values are those of the whole
    float32 tree cast after (also in
    ``tests/test_torch_dense_configs.py``'s leaf-by-leaf test), and the
    rows of a leaf are distinct draws."""
    cfg = dataclasses.replace(_small(get_config, arch), n_layers=3)
    got = init_serve_params(cfg, 0, device="cpu")
    w_gate = got["server"]["segments"][-1][0]["ffn"]["w_gate"]
    assert w_gate.dtype == torch.bfloat16 and w_gate.shape[0] == 2
    assert not torch.equal(w_gate[0], w_gate[1])
