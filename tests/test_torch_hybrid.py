"""Port parity on the SSM and hybrid configs: ``mamba2-370m`` (48 mamba
layers, no attention, no MLP) and ``jamba-v0.1-52b`` (attention on one
layer of 8, MoE 16 experts top-2 on every second), against the JAX
package.

The configs are compared at full size, at 16 layers (the card's jamba)
and at ``reduced()``.  The model runs at ``reduced()``: mamba2 two
mamba layers (one a side), jamba ``m a m a`` (mamba + dense FFN,
attention + MoE, on each side of the split), d_model 256.  The
reference's params cross over through numpy (``weights.from_numpy``:
its mamba leaves, stacked over ``n_rep``, as they come), tokens and
masks are numpy draws from a seed, and JAX runs on the CPU.

Tolerances are ``tests/test_torch_lm.py``'s ``TOL``: float32 logits to
1e-4 of their largest magnitude, caches to 1e-5 absolute (the SSM state
to 1e-5 of its largest magnitude: it sums up to a chunk of f32 terms in
another order); bfloat16 logits to 2e-2 of their largest magnitude.
Per-example gates are held to each client's fold on the port alone: the
reference's ``mamba_decode`` broadcasts a (B, 1, d_inner) gate against
its (B, d_inner) activation into (B, B, d_inner).  The engines are in
``tests/test_torch_hybrid_serve.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import INPUT_SHAPES
from repro.configs.base import get_config as jget_config
from repro.core import accounting as jacc
from repro.core import masks as jmasks
from repro.launch.steps import arch_window as jarch_window
from repro.launch.steps import init_serve_params as jinit_serve_params
from repro.models import decode as jdec
from repro.models import transformer as jtfm
from repro_torch.configs.base import InputShape, get_config, list_archs
from repro_torch.core import accounting as tacc
from repro_torch.core import masks as tmasks
from repro_torch.launch.steps import arch_window, init_serve_params
from repro_torch.models import decode as tdec
from repro_torch.models import transformer as ttfm
from repro_torch.weights import from_numpy, to_numpy, tree_leaves, tree_map

ARCHS = ("mamba2-370m", "jamba-v0.1-52b")
B, S, N_CLIENTS = 3, 12, 3
TOL = {"float32": (1e-4, 1e-5), "bfloat16": (2e-2, 2e-2)}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The tensors here are small: torch's intra-op threads would only
    contend with each other (and with other processes) on a CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _plan(plan):
    return [tuple((d.mixer, d.ffn, d.cross, d.causal) for d in s.body)
            + (s.n_rep,) for s in plan]


# ---------------------------------------------------------------------------
# configs, plans, counts, windows
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("size", ["full", "16-layer", "reduced"])
def test_config_matches_reference(arch, size):
    """Every field, the split, the parameter counts, the segment plans
    and the accounting's FLOPs per token."""
    j, t = jget_config(arch), get_config(arch)
    if size == "reduced":
        j, t = j.reduced(), t.reduced()
    elif size == "16-layer":
        j, t = (dataclasses.replace(c, n_layers=16) for c in (j, t))
    for f in dataclasses.fields(t):
        assert getattr(t, f.name) == getattr(j, f.name), f.name
    assert (t.split_layer, t.padded_vocab(), t.param_count(),
            t.active_param_count(), t.d_inner, t.ssm_nheads,
            t.supports_long_context()) == \
        (j.split_layer, j.padded_vocab(), j.param_count(),
         j.active_param_count(), j.d_inner, j.ssm_nheads,
         j.supports_long_context())
    for side in ("client_segments", "server_segments"):
        assert _plan(ttfm.model_plan(t)[side]) == \
            _plan(jtfm.model_plan(j)[side])
    for part in ("client", "server", "full"):
        assert tacc.transformer_matmul_params(t, part) == \
            jacc.transformer_matmul_params(j, part)
        assert tacc.transformer_flops_per_token(t, part, 512) == \
            jacc.transformer_flops_per_token(j, part, 512)


def test_full_size_counts_and_plans():
    m, jb = get_config("mamba2-370m"), get_config("jamba-v0.1-52b")
    assert (m.param_count(), m.active_param_count()) == \
        (368_074_752, 368_074_752)
    assert (jb.param_count(), jb.active_param_count()) == \
        (51_459_264_000, 11_999_251_968)
    assert dataclasses.replace(jb, n_layers=16).param_count() == \
        25_998_067_456
    plan = ttfm.model_plan(m)
    assert _plan(plan["client_segments"]) == [
        (("ssm", "none", False, True), 10)]
    assert _plan(plan["server_segments"]) == [
        (("ssm", "none", False, True), 38)]
    body = tuple(("attn" if i == 4 else "ssm", "moe" if i % 2 else "dense",
                  False, True) for i in range(8))
    for n, reps in ((32, (1, 3)), (16, (1, 1))):
        plan = ttfm.model_plan(dataclasses.replace(jb, n_layers=n))
        assert _plan(plan["client_segments"]) == [body + (reps[0],)]
        assert _plan(plan["server_segments"]) == [body + (reps[1],)]
    red = ttfm.model_plan(jb.reduced())
    for side in ("client_segments", "server_segments"):
        assert _plan(red[side]) == [(("ssm", "dense", False, True),
                                     ("attn", "moe", False, True), 1)]


@pytest.mark.parametrize("shape", sorted(INPUT_SHAPES))
def test_arch_window_matches_reference(shape):
    """For every registered arch (and lenet-cifar): the long-context
    window only where ``supports_long_context() == "windowed"``; a pure
    SSM stack (mamba2) gets none at long_500k."""
    js = INPUT_SHAPES[shape]
    ts = InputShape(js.name, js.seq_len, js.global_batch, js.kind)
    for arch in list_archs(include_paper=True):
        assert arch_window(get_config(arch), ts) == \
            jarch_window(jget_config(arch), js), arch
    if shape == "long_500k":
        assert arch_window(get_config("mamba2-370m"), ts) == 0
        assert arch_window(get_config("jamba-v0.1-52b"), ts) == 8192


# ---------------------------------------------------------------------------
# the stack: params, prefill, decode, masks
# ---------------------------------------------------------------------------


def _cfgs(arch, dtype):
    return (dataclasses.replace(jget_config(arch).reduced(), dtype=dtype),
            dataclasses.replace(get_config(arch).reduced(), dtype=dtype))


@pytest.fixture(scope="module",
                params=[(a, d) for a in ARCHS
                        for d in ("float32", "bfloat16")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def model(request):
    """(dtype, jax cfg, torch cfg, jax params, torch params, jax masks,
    torch masks) for one arch and compute dtype."""
    arch, dtype = request.param
    jcfg, tcfg = _cfgs(arch, dtype)
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


def _close_caches(got, want):
    """float32: attention K/V and the conv tail to 1e-5 absolute, the SSM
    state to 1e-5 of its largest magnitude."""
    g = tree_leaves(to_numpy(got))
    w = jax.tree.leaves(_np_tree(want))
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-5 * max(1.0, np.abs(b).max()))


def test_param_tree_matches_reference(model):
    """The reference's serving params, through ``weights.from_numpy``,
    have the port's own init's keys, shapes and dtypes: the mamba leaves
    (``in_proj``, ``conv_w``, ``conv_b``, ``A_log``, ``D``, ``dt_bias``,
    ``norm_scale``, ``out_proj``) stacked over ``n_rep``, and jamba's
    attention and MoE leaves."""
    dtype, _, tcfg, _, tp, _, _ = model
    own = init_serve_params(tcfg, 0, dtype, device="cpu")
    assert tree_map(lambda t: None, own) == tree_map(lambda t: None, tp)
    for a, b in zip(tree_leaves(own), tree_leaves(tp)):
        assert (a.shape, a.dtype) == (b.shape, b.dtype)
    mixer = tp["server"]["segments"][0][0]["mixer"]
    assert sorted(mixer) == sorted(("in_proj", "conv_w", "conv_b", "A_log",
                                    "D", "dt_bias", "norm_scale",
                                    "out_proj"))
    assert mixer["A_log"].shape == (1, tcfg.ssm_nheads)


def test_unit_masks_match_reference(model):
    _, jcfg, tcfg, _, _, _, _ = model
    want = jmasks.init_unit_masks(jcfg, N_CLIENTS)
    got = tmasks.init_unit_masks(tcfg, N_CLIENTS, device="cpu")
    assert [tuple(t.shape) for t in tree_leaves(got)] == \
        [w.shape for w in jax.tree.leaves(want)]
    assert got[0]["0"]["mixer"].shape == (N_CLIENTS, 1, tcfg.d_inner)


def test_prefill_logits_and_caches(model):
    dtype, jcfg, tcfg, jp, tp, _, _ = model
    toks = _tokens(jcfg, 1)
    want, wcache = jdec.prefill(jcfg, jp, jnp.asarray(toks), cache_len=S + 4)
    got, gcache = tdec.prefill(tcfg, tp, torch.from_numpy(toks),
                               cache_len=S + 4)
    assert got.shape == (B, 1, tcfg.padded_vocab())
    _close_logits(got, want, dtype)
    assert [(a.shape, str(a.dtype)) for a in tree_leaves(to_numpy(gcache))] \
        == [(b.shape, str(np.asarray(b, np.float32).dtype))
            for b in jax.tree.leaves(_np_tree(wcache))]
    if dtype == "float32":
        _close_caches(gcache, wcache)


def test_decode_steps_teacher_forced(model):
    """Three decode steps from the reference's own prefill cache, fed the
    same tokens on both sides; the port's cache updated in place."""
    dtype, jcfg, tcfg, jp, tp, _, _ = model
    _, jcache = jdec.prefill(jcfg, jp, jnp.asarray(_tokens(jcfg, 2)),
                             cache_len=S + 4)
    tcache = from_numpy(_np_tree(jcache), "cpu")
    nxt = _tokens(jcfg, 3, (3, B, 1))
    for t in range(3):
        want, jcache = jdec.decode_step(jcfg, jp, jnp.asarray(nxt[t]),
                                        jcache, jnp.asarray(S + t, jnp.int32))
        got, tcache = tdec.decode_step(tcfg, tp, torch.from_numpy(nxt[t]),
                                       tcache, S + t)
        _close_logits(got, want, dtype)
        if dtype == "float32":
            _close_caches(tcache, jcache)


def test_init_cache_matches_reference(model):
    dtype, jcfg, tcfg, _, _, _, _ = model
    want = jdec.init_cache(jcfg, B, S)
    got = tdec.init_cache(tcfg, B, S, device="cpu")
    assert [(tuple(a.shape), str(a.dtype).replace("torch.", ""))
            for a in tree_leaves(got)] == \
        [(b.shape, str(b.dtype)) for b in jax.tree.leaves(want)]


def test_client_gates_and_fold(model):
    """One client's gates (heads, mamba inner channels, FFN units,
    experts) against the reference's gated prefill and decode, and the
    port's fold (``out_proj`` rows for a mamba mixer) against its own
    gates."""
    dtype, jcfg, tcfg, jp, tp, jm, tm = model
    toks = _tokens(jcfg, 6)
    jg, tg = jmasks.gates_for_client(jm, 1), tmasks.gates_for_client(tm, 1)
    want, jcache = jdec.prefill(jcfg, jp, jnp.asarray(toks), gates=jg,
                                cache_len=S + 2)
    got, tcache = tdec.prefill(tcfg, tp, torch.from_numpy(toks), gates=tg,
                               cache_len=S + 2)
    _close_logits(got, want, dtype)
    nxt = _tokens(jcfg, 7, (B, 1))
    want, _ = jdec.decode_step(jcfg, jp, jnp.asarray(nxt), jcache,
                               jnp.asarray(S, jnp.int32), gates=jg)
    folded = dict(tp, server=tmasks.fold_unit_masks(tcfg, tp["server"], tm,
                                                    1))
    f_pre, f_cache = tdec.prefill(tcfg, folded, torch.from_numpy(toks),
                                  cache_len=S + 2)
    got, _ = tdec.decode_step(tcfg, tp, torch.from_numpy(nxt), tcache, S,
                              gates=tg)
    _close_logits(got, want, dtype)
    f_got, _ = tdec.decode_step(tcfg, folded, torch.from_numpy(nxt),
                                f_cache, S)
    tol = 5e-2 if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(f_got.numpy(), got.numpy(), rtol=tol,
                               atol=tol)
    jfold = jmasks.fold_unit_masks(jcfg, jp["server"], jm, 1)
    for a, b in zip(tree_leaves(to_numpy(folded["server"])),
                    jax.tree.leaves(_np_tree(jfold))):
        np.testing.assert_array_equal(a, np.asarray(b, np.float32))


@pytest.mark.parametrize("arch", ARCHS)
def test_per_example_gates_equal_each_clients_fold(arch):
    """A batch of three clients through per-example gates (prefill and a
    decode step) gives each row its own client's folded-server logits
    (float32: in bf16 the fold rounds weights where the gates round
    activations)."""
    dtype = "float32"
    _, tcfg = _cfgs(arch, dtype)
    tp = init_serve_params(tcfg, 0, dtype, device="cpu")
    gen = torch.Generator().manual_seed(9)
    tm = tree_map(lambda m: (torch.rand(m.shape, generator=gen) > 0.4)
                  .to(m.dtype), tmasks.init_unit_masks(tcfg, N_CLIENTS,
                                                       device="cpu"))
    clients = [2, 0, 2]
    toks = _tokens(tcfg, 8)
    nxt = _tokens(tcfg, 9, (B, 1))
    tg = tmasks.expand_gates(tm, clients)
    lg, cache = tdec.prefill(tcfg, tp, torch.from_numpy(toks), gates=tg,
                             cache_len=S + 2)
    dg, _ = tdec.decode_step(tcfg, tp, torch.from_numpy(nxt), cache, S,
                             gates=tg)
    for i, c in enumerate(clients):
        fp = dict(tp, server=tmasks.fold_unit_masks(tcfg, tp["server"], tm,
                                                    c))
        lf, cf = tdec.prefill(tcfg, fp, torch.from_numpy(toks[i:i + 1]),
                              cache_len=S + 2)
        df, _ = tdec.decode_step(tcfg, fp, torch.from_numpy(nxt[i:i + 1]),
                                 cf, S)
        _close_logits(lg[i:i + 1], lf.numpy(), dtype)
        _close_logits(dg[i:i + 1], df.numpy(), dtype)


def test_ragged_prefill_refused(model):
    _, _, tcfg, _, tp, _, _ = model
    with pytest.raises(ValueError, match="ragged"):
        tdec.prefill(tcfg, tp, torch.from_numpy(_tokens(tcfg, 1)),
                     last_index=torch.tensor([S - 1, 4, 8]))
