"""Port parity: personalized serving — ``repro_torch.launch.serve``'s
``serve_session`` and ``repro_torch.serve.ServeEngine`` — against the
JAX package's, on ``qwen2-0.5b``'s ``reduced()`` config in float32.

The config and params are float32 (``dataclasses.replace(cfg,
dtype="float32")``, ``init_serve_params(..., dtype="float32")``): with
a random model the logits are nearly flat, and in bfloat16 two
frameworks' roundings can tip a greedy argmax at a near-tie and send the
rest of a sequence elsewhere; in float32 the greedy tokens must be
EQUAL.  The reference's params and masks cross over through numpy;
prompts are numpy draws from a seed.  Engine statistics that count
(requests, tokens, batches, steps, fold and gate cache hits and misses)
must be equal too."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.core import masks as jmasks
from repro.launch import serve as jserve
from repro.launch.steps import init_serve_params as jinit_serve_params
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro_torch.configs.base import get_config
from repro_torch.core import masks as tmasks
from repro_torch.launch import serve as tserve
from repro_torch.serve import Request, ServeEngine
from repro_torch.weights import from_numpy, tree_leaves

N_CLIENTS = 3
# (client, prompt_len, max_new): ragged prompts and budgets, interleaved
# clients, so the client policy splits batches and the mixed one mixes
SPEC = [(0, 9, 4), (1, 6, 3), (0, 12, 5), (2, 7, 2), (1, 11, 4),
        (2, 5, 5), (0, 8, 3), (1, 10, 2)]
COUNTERS = ("requests", "tokens", "completed", "batches", "decode_steps",
            "slot_steps", "slot_capacity", "mixed_batches", "fold_hits",
            "fold_misses", "gate_hits", "gate_misses")


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(jget_config("qwen2-0.5b").reduced(),
                               dtype="float32")
    tcfg = dataclasses.replace(get_config("qwen2-0.5b").reduced(),
                               dtype="float32")
    jp = jinit_serve_params(jcfg, jax.random.PRNGKey(0), dtype="float32")
    rng = np.random.default_rng(9)
    jm = jax.tree.map(lambda m: jnp.asarray(
        (rng.random(m.shape) > 0.4).astype(np.float32)),
        jmasks.init_unit_masks(jcfg, N_CLIENTS))
    to_t = lambda t: from_numpy(jax.tree.map(np.asarray, t), "cpu")
    prompts = [rng.integers(0, jcfg.vocab_size, pl).astype(np.int32)
               for _, pl, _ in SPEC]
    return jcfg, tcfg, jp, to_t(jp), jm, to_t(jm), prompts


def test_serve_session_tokens_equal(setup):
    """The session CLI's path: one client's mask folded into the server,
    equal-length prompts, greedy decode."""
    jcfg, tcfg, jp, tp, jm, tm, _ = setup
    jp = dict(jp, server=jmasks.fold_unit_masks(jcfg, jp["server"], jm, 1))
    tp = dict(tp, server=tmasks.fold_unit_masks(tcfg, tp["server"], tm, 1))
    prompts = np.random.default_rng(3).integers(
        0, jcfg.vocab_size, (3, 10)).astype(np.int32)
    want = np.asarray(jserve.serve_session(jcfg, jp, jnp.asarray(prompts),
                                           6))
    got = tserve.serve_session(tcfg, tp, prompts, 6, device="cpu")
    assert got.dtype == torch.int32 and got.shape == (3, 6)
    np.testing.assert_array_equal(got.numpy(), want)


def test_serve_cli_runs_on_the_cpu(capsys):
    out = tserve.main(["--reduced", "--device", "cpu", "--fold-mask",
                       "--batch", "2", "--prompt-len", "8", "--gen", "3"])
    assert out.shape == (2, 3)
    cfg = get_config("qwen2-0.5b").reduced()
    assert ((out >= 0) & (out < cfg.vocab_size)).all()
    assert "folded client 0 mask" in capsys.readouterr().out


def _serve(engine_cls, request_cls, cfg, params, masks, prompts, mixed,
           **kw):
    eng = engine_cls(cfg, params, masks, max_batch=4, fold_cache_size=2,
                     mixed_batches=mixed, **kw)
    for i, ((c, _, mn), p) in enumerate(zip(SPEC, prompts)):
        eng.submit(request_cls(i, c, p, mn))
    done = eng.run_until_idle()
    return {r.req_id: r.output for r in done}, eng.stats


@pytest.mark.parametrize("mixed", [False, True],
                         ids=["fold-per-client", "gates-mixed"])
def test_engine_tokens_and_stats_equal(setup, mixed):
    jcfg, tcfg, jp, tp, jm, tm, prompts = setup
    want, jstats = _serve(JServeEngine, JRequest, jcfg, jp, jm, prompts,
                          mixed)
    got, tstats = _serve(ServeEngine, Request, tcfg, tp, tm, prompts, mixed,
                         device="cpu")
    assert sorted(got) == sorted(want) == list(range(len(SPEC)))
    for i in want:
        assert got[i].shape == (SPEC[i][2],)
        np.testing.assert_array_equal(got[i], np.asarray(want[i]))
    for name in COUNTERS:
        assert getattr(tstats, name) == getattr(jstats, name), name
    assert tstats.mixed_batches > 0 if mixed else tstats.fold_misses == 3


def test_mixed_gates_equal_folded_weights(setup):
    """Per-example gates (mixed batches) and folded weights (per-client
    batches) serve every request the same tokens."""
    _, tcfg, _, tp, _, tm, prompts = setup
    gated, _ = _serve(ServeEngine, Request, tcfg, tp, tm, prompts, True,
                      device="cpu")
    folded, _ = _serve(ServeEngine, Request, tcfg, tp, tm, prompts, False,
                       device="cpu")
    for i in gated:
        np.testing.assert_array_equal(gated[i], folded[i])


def test_entry_points_default_to_the_card(setup):
    import inspect
    from repro_torch.launch.steps import init_serve_params
    _, tcfg, _, tp, _, tm, _ = setup
    assert ServeEngine(tcfg, tp, tm).device == torch.device("cuda")
    for fn in (tserve.serve_session, init_serve_params):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    assert all(t.device.type == "cpu" for t in tree_leaves(tp))


# ---------------------------------------------------------------------------
# MoE: reduced deepseek-moe-16b (its dense first layer on the client, a
# two-layer MoE segment on the server), float32
# ---------------------------------------------------------------------------

# a 30-token prompt pads its batch to C = 24 (30 x top-2 / 4 experts x
# 1.25, rounded up to 8) where the 5- and 6-token prompts alone get C = 8
MOE_SPEC = [(0, 30, 3), (1, 5, 4), (0, 9, 2), (2, 6, 3), (1, 17, 2),
            (2, 12, 3)]


def _moe_cfg(get):
    return dataclasses.replace(get("deepseek-moe-16b").reduced(),
                               first_k_dense=1, n_layers=3, dtype="float32")


@pytest.fixture(scope="module")
def moe_setup():
    jcfg, tcfg = _moe_cfg(jget_config), _moe_cfg(get_config)
    jp = jinit_serve_params(jcfg, jax.random.PRNGKey(1), dtype="float32")
    rng = np.random.default_rng(11)
    jm = jax.tree.map(lambda m: jnp.asarray(
        (rng.random(m.shape) > 0.4).astype(np.float32)),
        jmasks.init_unit_masks(jcfg, N_CLIENTS))
    to_t = lambda t: from_numpy(jax.tree.map(np.asarray, t), "cpu")
    prompts = [rng.integers(0, jcfg.vocab_size, pl).astype(np.int32)
               for _, pl, _ in MOE_SPEC]
    return jcfg, tcfg, jp, to_t(jp), jm, to_t(jm), prompts


@pytest.mark.parametrize("mixed", [False, True],
                         ids=["fold-per-client", "gates-mixed"])
def test_moe_engine_tokens_and_stats_equal(moe_setup, mixed):
    """The FIFO engine on the MoE stack in both batching modes: the
    tokens and counting stats of the reference's same engine (each
    batch's capacity follows its padded length on both sides)."""
    jcfg, tcfg, jp, tp, jm, tm, prompts = moe_setup
    spec = dict(enumerate(MOE_SPEC))

    def serve(engine_cls, request_cls, cfg, params, masks, **kw):
        eng = engine_cls(cfg, params, masks, max_batch=3, fold_cache_size=2,
                         mixed_batches=mixed, **kw)
        for i, ((c, _, mn), p) in enumerate(zip(MOE_SPEC, prompts)):
            eng.submit(request_cls(i, c, p, mn))
        return {r.req_id: r.output for r in eng.run_until_idle()}, eng.stats
    from repro_torch.models.moe import _capacity
    assert (_capacity(30, tcfg), _capacity(6, tcfg)) == (24, 8)
    want, jstats = serve(JServeEngine, JRequest, jcfg, jp, jm)
    got, tstats = serve(ServeEngine, Request, tcfg, tp, tm, device="cpu")
    assert sorted(got) == sorted(want) == list(spec)
    for i in want:
        assert got[i].shape == (spec[i][2],)
        np.testing.assert_array_equal(got[i], np.asarray(want[i]))
    for name in COUNTERS:
        assert getattr(tstats, name) == getattr(jstats, name), name


def test_moe_serve_session_tokens_equal(moe_setup):
    """The session CLI's path on the MoE stack: client 1's expert and
    head masks folded, greedy decode."""
    jcfg, tcfg, jp, tp, jm, tm, _ = moe_setup
    jp = dict(jp, server=jmasks.fold_unit_masks(jcfg, jp["server"], jm, 1))
    tp = dict(tp, server=tmasks.fold_unit_masks(tcfg, tp["server"], tm, 1))
    prompts = np.random.default_rng(5).integers(
        0, jcfg.vocab_size, (3, 10)).astype(np.int32)
    want = np.asarray(jserve.serve_session(jcfg, jp, jnp.asarray(prompts),
                                           5))
    got = tserve.serve_session(tcfg, tp, prompts, 5, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


def test_moe_serve_cli_runs_on_the_cpu(capsys):
    """A ``--reduced --device cpu`` session of deepseek-moe-16b through
    the serve CLI, its expert masks folded."""
    out = tserve.main(["--arch", "deepseek-moe-16b", "--reduced", "--device",
                       "cpu", "--fold-mask", "--batch", "2", "--prompt-len",
                       "8", "--gen", "3"])
    assert out.shape == (2, 3)
    cfg = get_config("deepseek-moe-16b").reduced()
    assert ((out >= 0) & (out < cfg.vocab_size)).all()
    assert "folded client 0 mask" in capsys.readouterr().out
