"""Port parity of the encoder-decoder family (``seamless-m4t-large-v2``
at ``reduced()``, float32: 2 encoder layers, one on the client, and 2
decoder layers with cross-attention; d_model 256, 4/4 heads of 64, LN
norms, 16 source frames) against the JAX package: the config, its
counts and plans, ``cross_kv`` and ``kv_override`` attention at prefill
and decode, the forward pass, prefill and decode, the serving session,
the FIFO engine's equal-length split, the continuous engine's refusal,
the masks and fold over the decoder, the FLOP model and one LM train
step.

The reference's encoder-decoder prefill caches only a BOS token (slot 0
of each decoder self-attention cache), and its serving paths then
decode from position S, the prompt's length: every decode step attends
to S - 1 zero keys in slots 1..S-1 beside the real ones.  The port
reproduces this token for token (``test_decode_starts_at_the_prompt_length``).

Tolerances (float32, the same math in other summation orders): logits,
activations and caches to 2e-5 of the reference's largest magnitude;
greedy tokens and engine counters equal.  The train step is held as in
``tests/test_torch_lm_train.py``, against the composed oracle that file
defines (here with ``src_embeds`` threaded through it).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.core import masks as jmasks
from repro.core.accounting import transformer_matmul_params as jmatmul
from repro.launch import serve as jserve
from repro.launch.steps import LaunchPolicy as JPolicy
from repro.launch.steps import init_serve_params as jinit_serve_params
from repro.launch.steps import init_train_state as jinit_train_state
from repro.models import attention as jattn
from repro.models import decode as jdec
from repro.models import transformer as jtfm
from repro.serve import ContinuousEngine as JContinuousEngine
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro_torch.configs.base import InputShape, get_config
from repro_torch.core import masks as tmasks
from repro_torch.core.accounting import transformer_matmul_params
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import attention as tattn
from repro_torch.models import decode as tdec
from repro_torch.models import transformer as ttfm
from repro_torch.serve import ContinuousEngine, Request, ServeEngine
from repro_torch.weights import (from_numpy, to_numpy, train_state_from_numpy,
                                 tree_leaves)
from test_torch_lm_train import (_close_tree, _close_update, _np,
                                 _refuse_flash, oracle_step)

ARCH = "seamless-m4t-large-v2"
B, S, SK = 2, 10, 12            # decoder prompt length, source frames
N_CLIENTS = 3
TOL = 2e-5
# the chunked cross-attention, both sides rounding q, k, v and P to bf16:
# they differ only where a P falls on either side of a bf16 rounding
# step (seen up to 5.8e-4 of the output's largest magnitude), while the
# unrounded f32 einsum lies 2.8e-3 to 3.3e-3 away (seeds 2-4)
CHUNKED_TOL = 1e-3
COUNTERS = ("requests", "tokens", "completed", "batches", "decode_steps",
            "slot_steps", "slot_capacity", "mixed_batches", "fold_hits",
            "fold_misses", "gate_hits", "gate_misses")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The tensors here are small: torch's intra-op threads would only
    contend with each other (and with other processes) on a CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, what=""):
    want = np.asarray(want, np.float32)
    got = got.detach().numpy() if torch.is_tensor(got) else got
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= TOL, f"{what}: {err:.3g}"


def _cfgs():
    return tuple(dataclasses.replace(get(ARCH).reduced(), dtype="float32")
                 for get in (jget_config, get_config))


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = _cfgs()
    jp = jax.jit(lambda k: jinit_serve_params(jcfg, k, dtype="float32"))(
        jax.random.PRNGKey(0))
    rng = np.random.default_rng(5)
    jm = jax.tree.map(lambda m: jnp.asarray(
        (rng.random(m.shape) > 0.4).astype(np.float32)),
        jmasks.init_unit_masks(jcfg, N_CLIENTS))
    to_t = lambda t: from_numpy(jax.tree.map(np.asarray, t), "cpu")
    return jcfg, tcfg, jp, to_t(jp), jm, to_t(jm)


def _inputs(cfg, seed, b=B, s=S, sk=SK):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    src = rng.normal(0, 1, (b, sk, cfg.d_model)).astype(np.float32)
    return toks, src


# ---------------------------------------------------------------------------
# config, counts, plans
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("size", ["full", "reduced"])
def test_config_counts_and_plans(size):
    full_j, full_t = jget_config(ARCH), get_config(ARCH)
    j, t = (full_j, full_t) if size == "full" else (full_j.reduced(),
                                                    full_t.reduced())
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.param_count() == j.param_count()
    assert t.split_layer == j.split_layer == (5 if size == "full" else 1)
    for part in ("client", "server", "full"):
        assert transformer_matmul_params(t, part) == jmatmul(j, part)
    wp, gp = jtfm.model_plan(j), ttfm.model_plan(t)
    assert sorted(gp) == sorted(wp) == ["client_segments",
                                        "server_dec_segments",
                                        "server_enc_segments"]
    for k in wp:
        assert [(s.n_rep, tuple(dataclasses.astuple(d) for d in s.body))
                for s in gp[k]] == \
            [(s.n_rep, tuple(dataclasses.astuple(d) for d in s.body))
             for s in wp[k]], k
    assert all(not d.causal and not d.cross
               for s in gp["client_segments"] + gp["server_enc_segments"]
               for d in s.body)
    assert all(d.causal and d.cross for s in gp["server_dec_segments"]
               for d in s.body)


def test_params_masks_and_caches_match_reference(model):
    """The serving init's tree (no client token embedding; the server's
    encoder half, ``dec_embed`` and each decoder layer's ``cross`` and
    ``norm_x``), the unit masks over the decoder segments and the
    decode cache with its cross K/V, leaf for leaf."""
    jcfg, tcfg, jp, tp = model[:4]
    own = tsteps.init_serve_params(tcfg, 0, "float32", device="cpu")
    assert "embed" not in own["client"] and "frontend_proj" in own["client"]
    assert [(tuple(a.shape), a.dtype) for a in tree_leaves(own)] == \
        [(tuple(b.shape), b.dtype) for b in tree_leaves(tp)]
    layer = own["server"]["segments"][0][0]
    assert sorted(layer) == ["cross", "ffn", "mixer", "norm1", "norm2",
                             "norm_x"]
    wm = jmasks.init_unit_masks(jcfg, N_CLIENTS)
    gm = tmasks.init_unit_masks(tcfg, N_CLIENTS, device="cpu")
    assert [tuple(a.shape) for a in tree_leaves(gm)] == \
        [b.shape for b in jax.tree.leaves(wm)]
    wc = jdec.init_cache(jcfg, B, S, src_len=SK)
    gc = tdec.init_cache(tcfg, B, S, device="cpu", src_len=SK)
    assert list(gc) == ["server"]
    assert [tuple(a.shape) for a in tree_leaves(gc)] == \
        [b.shape for b in jax.tree.leaves(wc)]


# ---------------------------------------------------------------------------
# cross-attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sq", [S, 3072], ids=["einsum", "chunked"])
def test_cross_attention_prefill(model, sq):
    """``cross_kv`` and ``attn_forward`` with ``kv_override`` (Sq != Sk):
    ``mha_einsum``, and above Sq = 2048 the reference's ``mha_chunked``
    (bf16 rounding; held to ``CHUNKED_TOL`` there, which the f32 einsum
    misses); never the flash kernel."""
    jcfg, tcfg, jp, tp = model[:4]
    jl = jax.tree.map(lambda a: a[0], jp["server"]["segments"][0][0]["cross"])
    tl = {k: v[0] for k, v in tp["server"]["segments"][0][0]["cross"].items()}
    rng = np.random.default_rng(2)
    b = 1 if sq > S else B
    x = rng.normal(0, 1, (b, sq, jcfg.d_model)).astype(np.float32)
    enc = rng.normal(0, 1, (b, SK, jcfg.d_model)).astype(np.float32)
    wk, wv = jattn.cross_kv(jl, jnp.asarray(enc), jcfg, jnp.float32)
    gk, gv = tattn.cross_kv(tl, torch.from_numpy(enc), tcfg, torch.float32)
    _close(gk, wk, "cross k")
    _close(gv, wv, "cross v")
    want, _ = jax.jit(lambda p, x, k, v: jattn.attn_forward(
        p, x, jcfg, positions=None, kv_override=(k, v)))(
        jl, jnp.asarray(x), wk, wv)
    flash = tattn.flash_attention
    tattn.flash_attention = _refuse_flash
    try:
        got, _ = tattn.attn_forward(tl, torch.from_numpy(x), tcfg,
                                    positions=None, kv_override=(gk, gv))
    finally:
        tattn.flash_attention = flash
    if sq > 2048:
        want = np.asarray(want)
        q = tattn._project(tl, torch.from_numpy(x), tcfg, torch.float32,
                           "q")[0]
        einsum = tattn._project_out(
            tl, tattn.mha_einsum(q, gk, gv, causal=False), None,
            torch.float32)
        err, einsum_err = (np.abs(o.numpy() - want).max()
                           / np.abs(want).max() for o in (got, einsum))
        assert err <= CHUNKED_TOL < einsum_err, (err, einsum_err)
    else:
        _close(got, want, "cross out")


def test_cross_attention_decode(model):
    jcfg, tcfg, jp, tp = model[:4]
    jl = jax.tree.map(lambda a: a[0], jp["server"]["segments"][0][0]["cross"])
    tl = {k: v[0] for k, v in tp["server"]["segments"][0][0]["cross"].items()}
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (B, 1, jcfg.d_model)).astype(np.float32)
    k = rng.normal(0, 1, (B, SK, 4, 64)).astype(np.float32)
    v = rng.normal(0, 1, (B, SK, 4, 64)).astype(np.float32)
    want, _ = jattn.attn_decode(jl, jnp.asarray(x), None, 5, jcfg,
                                kv_override=(jnp.asarray(k), jnp.asarray(v)))
    got, cache = tattn.attn_decode(tl, torch.from_numpy(x), None, 5, tcfg,
                                   kv_override=(torch.from_numpy(k),
                                                torch.from_numpy(v)))
    assert cache is None
    _close(got, want, "cross decode")


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def test_forward(model):
    """Client (the bottom encoder layer, frames through ``frontend_proj``)
    then server (the rest of the encoder, the decoder over it)."""
    jcfg, tcfg, jp, tp = model[:4]
    toks, src = _inputs(jcfg, 4, s=SK)
    want = jax.jit(lambda p, t, e: jtfm.client_forward(jcfg, p, t, e))(
        jp["client"], jnp.asarray(toks), {"src_embeds": jnp.asarray(src)})
    got = ttfm.client_forward(tcfg, tp["client"], torch.from_numpy(toks),
                              {"src_embeds": torch.from_numpy(src)})
    _close(got, want, "client acts")
    wl, _ = jax.jit(lambda p, a, t: jtfm.server_forward(jcfg, p, a, t))(
        jp["server"], want, jnp.asarray(toks))
    gl = ttfm.server_forward(tcfg, tp["server"], got, torch.from_numpy(toks))
    _close(gl[..., :jcfg.vocab_size], wl[..., :jcfg.vocab_size], "logits")


@pytest.fixture(scope="module")
def decoded(model):
    """The reference's prefill and four greedy decode steps from pos = S
    (its logits, tokens and final cache), and the port's, gated by
    client 1's masks."""
    jcfg, tcfg, jp, tp, jm, tm = model
    toks, src = _inputs(jcfg, 5)
    jg, tg = jmasks.gates_for_client(jm, 1), tmasks.gates_for_client(tm, 1)
    jprefill = jax.jit(lambda p, t, e, g: jdec.prefill(
        jcfg, p, t, e, gates=g, cache_len=S + 5))
    jstep = jax.jit(lambda p, t, c, pos, g: jdec.decode_step(
        jcfg, p, t, c, pos, gates=g))
    out = {}
    for side, (p, g, arr, prefill, step) in {
            "ref": (jp, jg, jnp.asarray, jprefill, jstep),
            "port": (tp, tg, torch.from_numpy,
                     lambda p, t, e, g: tdec.prefill(tcfg, p, t, e, gates=g,
                                                     cache_len=S + 5),
                     lambda p, t, c, pos, g: tdec.decode_step(
                         tcfg, p, t, c, pos, gates=g))}.items():
        lg, cache = prefill(p, arr(toks), {"src_embeds": arr(src)}, g)
        logits = [np.asarray(lg, np.float32)]
        for t in range(4):
            tok = np.array(np.asarray(logits[-1]).argmax(-1), np.int32)
            pos = jnp.asarray(S + t, jnp.int32) if side == "ref" else S + t
            lg, cache = step(p, arr(tok), cache, pos, g)
            logits.append(np.asarray(lg, np.float32))
        out[side] = (logits, cache)
    return out


def test_prefill_and_decode_tokens_and_logits(decoded):
    (wl, wc), (gl, gc) = decoded["ref"], decoded["port"]
    for t, (a, b) in enumerate(zip(gl, wl)):
        _close(a, b, f"logits {t}")
        np.testing.assert_array_equal(a.argmax(-1), b.argmax(-1))
    for a, b in zip(tree_leaves(gc), jax.tree.leaves(wc)):
        _close(a, b, "cache")


def test_decode_starts_at_the_prompt_length(model, decoded):
    """The reference's fact, kept: the prefill's BOS sits at slot 0, the
    decode steps write slots S..S+3, and slots 1..S-1 stay zero keys
    that every step attends to (a decode from position 1 gives other
    logits)."""
    jcfg, tcfg, jp, tp, jm, tm = model
    _, gc = decoded["port"]
    k = gc["server"][0]["0"]["mixer"]["k"]           # (n_rep, B, L, H, hd)
    assert k[:, :, 0].abs().max() > 0
    assert k[:, :, 1:S].abs().max() == 0
    assert (k[:, :, S:S + 3].abs().amax(dim=(-1, -2)) > 0).all()
    toks, src = _inputs(jcfg, 5)
    tg = tmasks.gates_for_client(tm, 1)
    lg, cache = tdec.prefill(tcfg, tp, torch.from_numpy(toks),
                             {"src_embeds": torch.from_numpy(src)},
                             gates=tg, cache_len=S + 5)
    tok = lg.argmax(-1).to(torch.int32)
    at_one, _ = tdec.decode_step(tcfg, tp, tok, cache, 1, gates=tg)
    assert (at_one.numpy() - decoded["port"][0][1]).__abs__().max() > 1e-3


def test_fold_over_the_decoder(model):
    """The folded decoder's leaves equal the reference's fold; its
    prefill and decode equal the gated model's."""
    jcfg, tcfg, jp, tp, jm, tm = model
    folded = dict(tp, server=tmasks.fold_unit_masks(tcfg, tp["server"], tm,
                                                    2))
    jfold = jmasks.fold_unit_masks(jcfg, jp["server"], jm, 2)
    for a, b in zip(tree_leaves(to_numpy(folded["server"])),
                    jax.tree.leaves(_np(jfold))):
        np.testing.assert_array_equal(a, b)
    toks, src = _inputs(jcfg, 6)
    ex = {"src_embeds": torch.from_numpy(src)}
    gates = tmasks.gates_for_client(tm, 2)
    gl, gc = tdec.prefill(tcfg, tp, torch.from_numpy(toks), ex, gates=gates,
                          cache_len=S + 2)
    fl, fc = tdec.prefill(tcfg, folded, torch.from_numpy(toks), ex,
                          cache_len=S + 2)
    np.testing.assert_allclose(fl.numpy(), gl.numpy(), rtol=1e-5, atol=1e-5)
    tok = gl.argmax(-1).to(torch.int32)
    gd, _ = tdec.decode_step(tcfg, tp, tok, gc, S, gates=gates)
    fd, _ = tdec.decode_step(tcfg, folded, tok, fc, S)
    np.testing.assert_allclose(fd.numpy(), gd.numpy(), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def test_serve_session_tokens_equal(model):
    """The session (prefill, then decode from pos = S) with the CLI's
    bf16 source frames, on the reference's params."""
    jcfg, tcfg, jp, tp = model[:4]
    toks, src = _inputs(jcfg, 7)
    src16 = torch.from_numpy(src).to(torch.bfloat16)
    want = jserve.serve_session(jcfg, jp, jnp.asarray(toks), 5, extras={
        "src_embeds": jnp.asarray(src16.float().numpy(), jnp.bfloat16)})
    got = tserve.serve_session(tcfg, tp, toks, 5,
                               extras={"src_embeds": src16}, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# (client, prompt_len, max_new): two lengths, so the engines split the
# batch into equal-length sub-batches in the order of their first request
SPEC = [(0, 7, 3), (1, 5, 2), (2, 7, 4), (0, 5, 3)]


def _serve(engine_cls, request_cls, cfg, params, masks, prompts, **kw):
    eng = engine_cls(cfg, params, masks, max_batch=4, fold_cache_size=2,
                     mixed_batches=True, **kw)
    for i, ((c, _, mn), p) in enumerate(zip(SPEC, prompts)):
        eng.submit(request_cls(i, c, p, mn))
    done = eng.run_until_idle()
    return [r.req_id for r in done], {r.req_id: r.output for r in done}, \
        eng.stats


def test_fifo_splits_by_length_as_the_reference(model):
    """The mixed FIFO engine (zero source frames, as the reference's
    engine gives them): the reference's completion order, tokens and
    every counter."""
    jcfg, tcfg, jp, tp, jm, tm = model
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, jcfg.vocab_size, n).astype(np.int32)
               for _, n, _ in SPEC]
    jorder, want, jst = _serve(JServeEngine, JRequest, jcfg, jp, jm, prompts)
    order, got, tst = _serve(ServeEngine, Request, tcfg, tp, tm, prompts,
                             device="cpu")
    assert order == jorder == [0, 2, 1, 3]
    for i in want:
        np.testing.assert_array_equal(got[i], np.asarray(want[i]))
    for name in COUNTERS:
        assert getattr(tst, name) == getattr(jst, name), name
    assert tst.batches == 2


def test_continuous_engine_refuses_as_the_reference(model):
    jcfg, tcfg = model[:2]
    assert not tdec.slot_serving_ok(tcfg) and not jdec.slot_serving_ok(jcfg)
    with pytest.raises(ValueError) as want:
        JContinuousEngine(jcfg, None)
    with pytest.raises(ValueError) as got:
        ContinuousEngine(tcfg, None, device="cpu")
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def test_add_extras_draws_as_the_reference():
    from repro.launch.train import add_extras as jadd_extras
    r1, r2 = np.random.default_rng(4), np.random.default_rng(4)
    want = jadd_extras(jget_config(ARCH).reduced(), {}, 4, 16, r1)
    got = ttrain.add_extras(get_config(ARCH).reduced(), {}, 4, 16, r2)
    assert list(got) == list(want) == ["src_embeds"]
    assert got["src_embeds"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["src_embeds"].float().numpy(),
                                  np.asarray(want["src_embeds"], np.float32))
    assert r1.random() == r2.random()


def test_train_step_matches_reference(monkeypatch):
    """One global train step (C=2 cohorts of 4 rows, S=16, float32), the
    source frames through the client's encoder layer and the server's
    encoder and decoder, against the composed oracle: losses to 1e-5
    relative, gradients and moments to 5e-5 of each leaf's largest
    magnitude, Adam's moves within 1e-3 lr."""
    monkeypatch.setattr(tattn, "flash_attention", _refuse_flash)
    C, b, s = 2, 4, 16
    jcfg, tcfg = _cfgs()
    pol = JPolicy(microbatch=1, remat=False, param_dtype="float32")
    state0 = _np(jinit_train_state(jcfg, C, pol, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(3)
    batch = {"tokens": rng.integers(0, 512, (C * b, s)).astype(np.int32),
             "labels": rng.integers(0, 512, (C * b, s)).astype(np.int32),
             "seq_class": np.repeat(np.arange(C), b).astype(np.int32),
             "select": np.array([1, 0], np.float32),
             "src_embeds": rng.normal(0, 1, (C * b, s, 256)).astype(
                 np.float32)}
    want, wm = jax.jit(oracle_step(jcfg, C, C * b, pol))(state0, batch)
    want, wm = _np(want), _np(wm)
    tpol = tsteps.LaunchPolicy(microbatch=1, remat=False,
                               param_dtype="float32")
    like = tsteps.init_train_state(tcfg, C, tpol, 0, device="cpu")
    state = train_state_from_numpy(state0, "cpu", like=like)
    seen = {}
    adam = tsteps.adam_update

    def spy(params, grads, opt, *, lr):
        seen["grads"] = grads
        return adam(params, grads, opt, lr=lr)
    monkeypatch.setattr(tsteps, "adam_update", spy)
    fn = tsteps.build_train_step(tcfg, InputShape("t", s, C * b, "train"),
                                 tpol, n_cohorts=C)
    new, m = fn(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    for k in ("l_client", "ce"):
        np.testing.assert_allclose(float(m[k]), wm[k], rtol=1e-5)
    grads = to_numpy(seen["grads"])
    _close_tree(grads, wm["grads"], "float32", "grad")
    new = to_numpy(new)
    _close_tree(new["opt"]["mu"], want["opt"]["mu"], "float32", "mu")
    _close_update(new["trainables"], want["trainables"],
                  state0["trainables"], "float32")
    # the CE reaches the server's encoder through the cross-attention
    g = grads["server"]["enc_segments"][0][0]["mixer"]["wq"]
    assert np.abs(g).max() > 0


def test_remat_gives_equal_gradients(monkeypatch):
    """Each layer under ``torch.utils.checkpoint`` (the encoder states
    reach the decoder's recomputed cross-attentions through its inputs):
    the step's gradients bit-equal with remat on and off."""
    monkeypatch.setattr(tattn, "flash_attention", _refuse_flash)
    C, b, s = 2, 4, 8           # b >= 3: one class a cohort, a live loss
    _, tcfg = _cfgs()
    rng = np.random.default_rng(6)
    batch = {"tokens": rng.integers(0, 512, (C * b, s)).astype(np.int32),
             "labels": rng.integers(0, 512, (C * b, s)).astype(np.int32),
             "seq_class": np.repeat(np.arange(C), b).astype(np.int32),
             "select": np.ones((C,), np.float32),
             "src_embeds": rng.normal(0, 1, (C * b, s, 256)).astype(
                 np.float32)}
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    seen = []
    adam = tsteps.adam_update

    def spy(params, grads, opt, *, lr):
        seen.append(grads)
        return adam(params, grads, opt, lr=lr)
    monkeypatch.setattr(tsteps, "adam_update", spy)
    for remat in (True, False):
        pol = tsteps.LaunchPolicy(remat=remat, param_dtype="float32")
        state = tsteps.init_train_state(tcfg, C, pol, 0, device="cpu")
        tsteps.build_train_step(tcfg, InputShape("t", s, C * b, "train"),
                                pol, n_cohorts=C)(state, batch)
    for a, g in zip(tree_leaves(seen[0]), tree_leaves(seen[1])):
        assert torch.equal(a, g)
    for side, leaf in (("client", seen[0]["client"]["model"]["frontend_proj"]),
                       ("server", seen[0]["server"]["enc_segments"][0][0]
                        ["mixer"]["wq"])):
        assert leaf.abs().max() > 0, side
