"""Port parity of the vision-text family (``qwen2-vl-72b`` at
``reduced()``, float32: 2 layers, d_model 256, 4/4 heads of 64, M-RoPE
sections (16, 8, 8), 16 patch embeddings) against the JAX package:
``layers.apply_mrope``, M-RoPE attention at prefill and decode, the
client's patch splice, prefill and decode, the FIFO and continuous
engines, the fold and one LM train step.

M-RoPE with three equal streams is plain RoPE, and the reference's
serving paths pass equal streams (no ``positions``), so every M-RoPE
comparison here runs on DISTINCT streams: the F patches at (0, row,
col) of a 4 x 4 grid, the text after them at 4 + i on all three
(``vision_positions``).  One test checks that equal streams give
``apply_rope``.  The splice of the patch embeddings over the prompt's
prefix is skipped, silently, where S < F; both sides are tested.

Tolerances (float32, the same math in other summation orders): logits,
activations and caches to 2e-5 of the reference's largest magnitude;
greedy tokens and engine counters equal.  The train step is held as
``tests/test_torch_lm_train.py`` holds it, against the composed oracle
that file defines (here with the batch's ``vision_embeds`` and
``positions`` threaded through it).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.core import masks as jmasks
from repro.launch.steps import LaunchPolicy as JPolicy
from repro.launch.steps import init_serve_params as jinit_serve_params
from repro.launch.steps import init_train_state as jinit_train_state
from repro.models import attention as jattn
from repro.models import decode as jdec
from repro.models import layers as jlayers
from repro.models import transformer as jtfm
from repro.serve import ContinuousEngine as JContinuousEngine
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro_torch.configs.base import InputShape, get_config
from repro_torch.core import masks as tmasks
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import attention as tattn
from repro_torch.models import decode as tdec
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttfm
from repro_torch.serve import ContinuousEngine, Request, ServeEngine
from repro_torch.weights import (from_numpy, to_numpy, train_state_from_numpy,
                                 tree_leaves)
from test_torch_lm_train import (_close_tree, _close_update, _np,
                                 _refuse_flash, oracle_step)

ARCH = "qwen2-vl-72b"
B, S, GRID = 2, 24, 4           # F = GRID**2 = 16 patches
N_CLIENTS = 3
TOL = 2e-5
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


def vision_positions(b, s, grid):
    """(b, s, 3) int32 (t, h, w) streams: the grid x grid patches at
    (0, row, col), then the text at grid + i on all three."""
    f = grid * grid
    pos = np.empty((s, 3), np.int32)
    i = np.arange(min(f, s))
    pos[:len(i)] = np.stack([0 * i, i // grid, i % grid], axis=-1)
    pos[f:] = (grid + np.arange(max(s - f, 0)))[:, None]
    return np.broadcast_to(pos, (b, s, 3)).copy()


def _close(got, want, what=""):
    want = np.asarray(want, np.float32)
    got = got.detach().numpy() if torch.is_tensor(got) else got
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= TOL, f"{what}: {err:.3g}"


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = (dataclasses.replace(get(ARCH).reduced(), dtype="float32")
                  for get in (jget_config, get_config))
    jp = jax.jit(lambda k: jinit_serve_params(jcfg, k, dtype="float32"))(
        jax.random.PRNGKey(0))
    rng = np.random.default_rng(5)
    jm = jax.tree.map(lambda m: jnp.asarray(
        (rng.random(m.shape) > 0.4).astype(np.float32)),
        jmasks.init_unit_masks(jcfg, N_CLIENTS))
    to_t = lambda t: from_numpy(jax.tree.map(np.asarray, t), "cpu")
    return jcfg, tcfg, jp, to_t(jp), jm, to_t(jm)


def _inputs(cfg, seed, s=S):
    """Tokens (B, s), patch embeddings (B, F, D) and distinct streams."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, s)).astype(np.int32)
    ve = rng.normal(0, 1, (B, GRID ** 2, cfg.d_model)).astype(np.float32)
    return toks, {"vision_embeds": ve,
                  "positions": vision_positions(B, s, GRID)}


def _j(extras):
    return {k: jnp.asarray(v) for k, v in extras.items()}


def _t(extras):
    return {k: torch.from_numpy(v) for k, v in extras.items()}


# ---------------------------------------------------------------------------
# M-RoPE and attention
# ---------------------------------------------------------------------------


def test_config_matches_reference(model):
    jcfg, tcfg = model[:2]
    full_j, full_t = jget_config(ARCH), get_config(ARCH)
    assert dataclasses.asdict(full_t) == dataclasses.asdict(full_j)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.mrope_sections == (16, 8, 8) and tcfg.frontend_frames == 16
    assert full_t.param_count() == full_j.param_count()
    assert tcfg.split_layer == jcfg.split_layer == 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_mrope_distinct_streams(dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (B, S, 4, 64)).astype(np.float32)
    pos = vision_positions(B, S, GRID)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = jlayers.apply_mrope(jnp.asarray(x, jdt), jnp.asarray(pos),
                               1e6, (16, 8, 8))
    got = tlayers.apply_mrope(torch.from_numpy(x).to(getattr(torch, dtype)),
                              torch.from_numpy(pos), 1e6, (16, 8, 8))
    assert got.dtype == getattr(torch, dtype)
    tol = 2e-6 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol)
    # the streams are distinct: the result is not plain RoPE's (h and w
    # rotate the low frequencies, so the parting is small at theta 1e6,
    # but far above float32 rounding)
    rope = tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(
        pos[..., 0]), 1e6)
    assert (rope - got.float()).abs().max() > 1e-3


def test_equal_streams_are_rope():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(0, 1, (B, S, 4, 64)).astype(np.float32))
    p = torch.arange(S)[None, :].expand(B, S)
    got = tlayers.apply_mrope(x, p[..., None].expand(B, S, 3), 1e6,
                              (16, 8, 8))
    np.testing.assert_allclose(got.numpy(),
                               tlayers.apply_rope(x, p, 1e6).numpy(),
                               atol=1e-6)
    with pytest.raises(ValueError):
        tlayers.apply_mrope(x, p[..., None].expand(B, S, 3), 1e6, (16, 8))


def test_attention_prefill_and_decode_with_mrope(model):
    """``attn_forward`` at prefill (the flash path's plain version on the
    CPU) and ``attn_decode`` at a scalar and at per-slot positions,
    against the reference's, on distinct streams at prefill."""
    jcfg, tcfg, jp, tp = model[:4]
    jl, tl = jp["server"]["segments"][0][0]["mixer"], \
        tp["server"]["segments"][0][0]["mixer"]
    jl, tl = (jax.tree.map(lambda a: a[0], jl),
              {k: v[0] for k, v in tl.items()})
    rng = np.random.default_rng(2)
    x = rng.normal(0, 1, (B, S, jcfg.d_model)).astype(np.float32)
    pos = vision_positions(B, S, GRID)
    want, (wk, wv) = jax.jit(lambda p, x, pos: jattn.attn_forward(
        p, x, jcfg, positions=pos))(jl, jnp.asarray(x), jnp.asarray(pos))
    got, (gk, gv) = tattn.attn_forward(tl, torch.from_numpy(x), tcfg,
                                       positions=torch.from_numpy(pos))
    _close(got, want, "prefill out")
    _close(gk, wk, "k")
    _close(gv, wv, "v")
    L = S + 4
    cache = {"k": np.zeros((B, L) + wk.shape[2:], np.float32),
             "v": np.zeros((B, L) + wk.shape[2:], np.float32)}
    cache["k"][:, :S], cache["v"][:, :S] = np.asarray(wk), np.asarray(wv)
    xd = rng.normal(0, 1, (B, 1, jcfg.d_model)).astype(np.float32)
    jdecode = jax.jit(lambda p, x, c, pos: jattn.attn_decode(p, x, c, pos,
                                                             jcfg))
    for pos_d in (S, np.array([S, S - 3], np.int32)):
        jc = {k: jnp.asarray(v) for k, v in cache.items()}
        tc = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
        want, jc = jdecode(jl, jnp.asarray(xd), jc,
                           jnp.asarray(pos_d, jnp.int32))
        tpos = torch.from_numpy(pos_d) if np.ndim(pos_d) else pos_d
        got, tc = tattn.attn_decode(tl, torch.from_numpy(xd), tc, tpos, tcfg)
        _close(got, want, f"decode at {pos_d}")
        _close(tc["k"], jc["k"], "decode k")


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s", [S, GRID ** 2 - 4], ids=["splice", "short"])
def test_client_and_server_forward(model, s):
    """The client's patch splice (S >= F) and its silent skip (S < F);
    where it splices, the server's logits too, with distinct streams."""
    jcfg, tcfg, jp, tp = model[:4]
    toks, ex = _inputs(jcfg, 3, s)
    want = jax.jit(lambda p, t, e: jtfm.client_forward(jcfg, p, t, e))(
        jp["client"], jnp.asarray(toks), _j(ex))
    got = ttfm.client_forward(tcfg, tp["client"], torch.from_numpy(toks),
                              _t(ex))
    _close(got, want, "client acts")
    plain = ttfm.client_forward(tcfg, tp["client"], torch.from_numpy(toks),
                                {"positions": _t(ex)["positions"]})
    spliced = bool((plain - got).abs().max() > 0)
    assert spliced == (s >= GRID ** 2)
    if not spliced:
        return
    wl, _ = jax.jit(lambda p, a, t, e: jtfm.server_forward(jcfg, p, a, t, e))(
        jp["server"], want, jnp.asarray(toks), _j(ex))
    gl = ttfm.server_forward(tcfg, tp["server"], got, torch.from_numpy(toks),
                             _t(ex))
    _close(gl[..., :jcfg.vocab_size], wl[..., :jcfg.vocab_size], "logits")


def test_prefill_and_decode_tokens_and_logits(model):
    """One prefill with the patches spliced and distinct streams, then
    four greedy decode steps (each position on all three streams): the
    reference's tokens, logits within TOL, caches within TOL."""
    jcfg, tcfg, jp, tp = model[:4]
    toks, ex = _inputs(jcfg, 4)
    wl, jc = jax.jit(lambda p, t, e: jdec.prefill(jcfg, p, t, e,
                                                  cache_len=S + 5))(
        jp, jnp.asarray(toks), _j(ex))
    jstep = jax.jit(lambda p, t, c, pos: jdec.decode_step(jcfg, p, t, c,
                                                          pos))
    gl, tc = tdec.prefill(tcfg, tp, torch.from_numpy(toks), _t(ex),
                          cache_len=S + 5)
    for t in range(5):
        _close(gl, wl, f"logits {t}")
        tok = np.array(jnp.argmax(wl, -1), np.int32)
        np.testing.assert_array_equal(gl.argmax(-1).numpy(), tok)
        if t == 4:
            break
        wl, jc = jstep(jp, jnp.asarray(tok), jc,
                       jnp.asarray(S + t, jnp.int32))
        gl, tc = tdec.decode_step(tcfg, tp, torch.from_numpy(tok), tc, S + t)
    for a, b in zip(tree_leaves(tc), jax.tree.leaves(jc)):
        _close(a, b, "cache")


def test_fold_matches_reference(model):
    """The folded server leaves equal the reference's; the folded model's
    prefill and decode equal the gated one's."""
    jcfg, tcfg, jp, tp, jm, tm = model
    folded = dict(tp, server=tmasks.fold_unit_masks(tcfg, tp["server"], tm,
                                                    2))
    jfold = jmasks.fold_unit_masks(jcfg, jp["server"], jm, 2)
    for a, b in zip(tree_leaves(to_numpy(folded["server"])),
                    jax.tree.leaves(_np(jfold))):
        np.testing.assert_array_equal(a, b)
    toks, ex = _inputs(jcfg, 6)
    gates = tmasks.gates_for_client(tm, 2)
    gl, gc = tdec.prefill(tcfg, tp, torch.from_numpy(toks), _t(ex),
                          gates=gates, cache_len=S + 2)
    fl, fc = tdec.prefill(tcfg, folded, torch.from_numpy(toks), _t(ex),
                          cache_len=S + 2)
    np.testing.assert_allclose(fl.numpy(), gl.numpy(), rtol=1e-5, atol=1e-5)
    tok = gl.argmax(-1).to(torch.int32)
    gd, _ = tdec.decode_step(tcfg, tp, tok, gc, S, gates=gates)
    fd, _ = tdec.decode_step(tcfg, folded, tok, fc, S)
    np.testing.assert_allclose(fd.numpy(), gd.numpy(), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------

# (client, prompt_len, max_new): ragged prompts across mixed clients
SPEC = [(0, 9, 4), (1, 6, 3), (2, 12, 5), (0, 4, 2)]


def _run(eng, request_cls, prompts):
    reqs = [request_cls(i, c, p, mn)
            for i, ((c, _, mn), p) in enumerate(zip(SPEC, prompts))]
    for r in reqs:
        eng.submit(r)
    order = [r.req_id for r in eng.run_until_idle()]
    return order, {r.req_id: np.asarray(r.output) for r in reqs}, eng.stats


def _prompts(cfg):
    rng = np.random.default_rng(8)
    return [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
            for _, n, _ in SPEC]


def test_fifo_engine_equals_reference(model):
    """The mixed (gated) FIFO engine: one ragged batch of three clients;
    the folded per-client path is held by ``test_fold_matches_reference``."""
    jcfg, tcfg, jp, tp, jm, tm = model
    prompts = _prompts(jcfg)
    kw = dict(max_batch=4, fold_cache_size=2, mixed_batches=True)
    jorder, want, jst = _run(JServeEngine(jcfg, jp, jm, **kw), JRequest,
                             prompts)
    order, got, tst = _run(ServeEngine(tcfg, tp, tm, device="cpu", **kw),
                           Request, prompts)
    assert order == jorder
    for i in want:
        np.testing.assert_array_equal(got[i], want[i])
    for name in COUNTERS:
        assert getattr(tst, name) == getattr(jst, name), name


def test_continuous_engine_equals_reference(model):
    """The VLM rides the continuous engine (its per-slot positions on all
    three streams), as the reference's does."""
    jcfg, tcfg, jp, tp, jm, tm = model
    prompts = _prompts(jcfg)
    kw = dict(max_batch=3, cache_len=32)
    jeng = JContinuousEngine(jcfg, jp, jm, **kw)
    teng = ContinuousEngine(tcfg, tp, tm, device="cpu", **kw)
    jorder, want, jst = _run(jeng, JRequest, prompts)
    order, got, tst = _run(teng, Request, prompts)
    assert order == jorder
    for i in want:
        np.testing.assert_array_equal(got[i], want[i])
    for name in COUNTERS:
        assert getattr(tst, name) == getattr(jst, name), name
    assert teng.sched.admission_log == jeng.sched.admission_log


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def test_add_extras_draws_as_the_reference():
    """The trainer's modality inputs are the reference's draws from the
    same numpy stream, bit for bit, and leave the stream where the
    reference's leave it."""
    from repro.launch.train import add_extras as jadd_extras
    cfg = get_config(ARCH).reduced()
    r1, r2 = np.random.default_rng(4), np.random.default_rng(4)
    want = jadd_extras(jget_config(ARCH).reduced(), {}, 4, 20, r1)
    got = ttrain.add_extras(cfg, {}, 4, 20, r2)
    assert sorted(got) == sorted(want) == ["positions", "vision_embeds"]
    assert got["vision_embeds"].dtype == torch.bfloat16
    assert got["positions"].dtype == torch.int32
    for k in want:
        np.testing.assert_array_equal(got[k].float().numpy(),
                                      np.asarray(want[k], np.float32))
    assert r1.random() == r2.random()


def test_train_step_matches_reference(monkeypatch):
    """One global train step (C=2 cohorts of 4 rows, S=16, float32) with
    the patches spliced and distinct streams, against the composed
    oracle: losses to 1e-5 relative, gradients and moments to 5e-5 of
    each leaf's largest magnitude, Adam's moves within 1e-3 lr."""
    monkeypatch.setattr(tattn, "flash_attention", _refuse_flash)
    C, b, s = 2, 4, GRID ** 2 + 4
    jcfg, tcfg = (dataclasses.replace(get(ARCH).reduced(), dtype="float32")
                  for get in (jget_config, get_config))
    pol = JPolicy(microbatch=1, remat=False, param_dtype="float32")
    state0 = _np(jinit_train_state(jcfg, C, pol, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(3)
    batch = {"tokens": rng.integers(0, 512, (C * b, s)).astype(np.int32),
             "labels": rng.integers(0, 512, (C * b, s)).astype(np.int32),
             "seq_class": np.repeat(np.arange(C), b).astype(np.int32),
             "select": np.array([1, 0], np.float32),
             "vision_embeds": rng.normal(
                 0, 1, (C * b, GRID ** 2, 256)).astype(np.float32),
             "positions": vision_positions(C * b, s, GRID)}
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
    _close_tree(to_numpy(seen["grads"]), wm["grads"], "float32", "grad")
    new = to_numpy(new)
    _close_tree(new["opt"]["mu"], want["opt"]["mu"], "float32", "mu")
    _close_update(new["trainables"], want["trainables"],
                  state0["trainables"], "float32")
    # the patch projector learned from the client loss
    g = to_numpy(seen["grads"])["client"]["model"]["frontend_proj"]
    assert np.abs(g).max() > 0
