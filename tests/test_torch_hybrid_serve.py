"""Port parity of the serving engines and the session on the SSM and
hybrid configs (``mamba2-370m`` and ``jamba-v0.1-52b`` at ``reduced()``,
float32), against the JAX package: greedy tokens equal, as in
``tests/test_torch_serve.py``.

The FIFO engine on an SSM stack splits a ragged batch into equal-length
sub-batches in the order of their first request, as the reference's
``_ragged_ok`` fallback does.  The trace here keeps each such sub-batch
to one client in the mixed mode, because the reference's
``mamba_decode`` broadcasts a per-example gate against its (B, d_inner)
activation into (B, B, d_inner) (it runs only at B = 1); a sub-batch
that spans clients is held to the port's own folded per-client serving
instead.  The continuous engine refuses both configs with the
reference's error.
"""
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
from repro.models import decode as jdec
from repro.serve import ContinuousEngine as JContinuousEngine
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro_torch.configs.base import get_config
from repro_torch.core import masks as tmasks
from repro_torch.launch import serve as tserve
from repro_torch.models import decode as tdec
from repro_torch.serve import ContinuousEngine, Request, ServeEngine
from repro_torch.weights import from_numpy

ARCHS = ("mamba2-370m", "jamba-v0.1-52b")
N_CLIENTS = 3
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


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _cfgs(arch):
    return (dataclasses.replace(jget_config(arch).reduced(), dtype="float32"),
            dataclasses.replace(get_config(arch).reduced(), dtype="float32"))


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------

# (client, prompt_len, max_new): ragged prompts; with max_batch 4 every
# equal-length group of a mixed batch is one client's (see the module
# docstring), and the client policy's batches split too
SPEC = [(0, 9, 4), (1, 6, 3), (0, 9, 5), (2, 7, 2), (1, 6, 4), (2, 7, 3),
        (0, 9, 3), (1, 11, 2)]


@pytest.fixture(scope="module")
def engine_setup():
    jcfg, tcfg = _cfgs("mamba2-370m")
    jp = jinit_serve_params(jcfg, jax.random.PRNGKey(0), dtype="float32")
    rng = np.random.default_rng(9)
    jm = jax.tree.map(lambda m: jnp.asarray(
        (rng.random(m.shape) > 0.4).astype(np.float32)),
        jmasks.init_unit_masks(jcfg, N_CLIENTS))
    to_t = lambda t: from_numpy(_np_tree(t), "cpu")
    prompts = [rng.integers(0, jcfg.vocab_size, pl).astype(np.int32)
               for _, pl, _ in SPEC]
    return jcfg, tcfg, jp, to_t(jp), jm, to_t(jm), prompts


def _serve(engine_cls, request_cls, cfg, params, masks, prompts, mixed,
           spec=SPEC, **kw):
    eng = engine_cls(cfg, params, masks, max_batch=4, fold_cache_size=2,
                     mixed_batches=mixed, **kw)
    for i, ((c, _, mn), p) in enumerate(zip(spec, prompts)):
        eng.submit(request_cls(i, c, p, mn))
    done = eng.run_until_idle()
    return [r.req_id for r in done], {r.req_id: r.output for r in done}, \
        eng.stats


@pytest.mark.parametrize("mixed", [False, True],
                         ids=["fold-per-client", "gates-mixed"])
def test_fifo_splits_by_length_as_the_reference(engine_setup, mixed):
    """Requests complete in the reference's order (its equal-length
    sub-batches, in the order of their first request), with its tokens
    and every counter."""
    jcfg, tcfg, jp, tp, jm, tm, prompts = engine_setup
    jorder, want, jstats = _serve(JServeEngine, JRequest, jcfg, jp, jm,
                                  prompts, mixed)
    order, got, tstats = _serve(ServeEngine, Request, tcfg, tp, tm, prompts,
                                mixed, device="cpu")
    assert order == jorder
    for i in want:
        np.testing.assert_array_equal(got[i], np.asarray(want[i]))
    for name in COUNTERS:
        assert getattr(tstats, name) == getattr(jstats, name), name
    # more batches than the ragged policy would have formed
    assert tstats.batches > (2 if mixed else 3)


def test_fifo_sub_batch_across_clients_equals_folds(engine_setup):
    """Three clients' prompts of one length form one gated sub-batch in
    the mixed mode; each request gets the tokens its client's folded
    server gives it (the per-client mode)."""
    _, tcfg, _, tp, _, tm, _ = engine_setup
    spec = [(0, 8, 3), (1, 8, 4), (2, 8, 3), (0, 5, 2)]
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, tcfg.vocab_size, n).astype(np.int32)
               for _, n, _ in spec]
    _, gated, st = _serve(ServeEngine, Request, tcfg, tp, tm, prompts, True,
                          spec=spec, device="cpu")
    _, folded, _ = _serve(ServeEngine, Request, tcfg, tp, tm, prompts, False,
                          spec=spec, device="cpu")
    assert (st.batches, st.mixed_batches) == (2, 1)
    for i in gated:
        np.testing.assert_array_equal(gated[i], folded[i])


@pytest.mark.parametrize("arch", ARCHS)
def test_continuous_engine_refuses_as_the_reference(arch):
    t, j = get_config(arch).reduced(), jget_config(arch).reduced()
    assert not tdec.slot_serving_ok(t) and not jdec.slot_serving_ok(j)
    with pytest.raises(ValueError) as want:
        JContinuousEngine(j, None)
    with pytest.raises(ValueError) as got:
        ContinuousEngine(t, None, device="cpu")
    assert str(got.value) == str(want.value)


def test_serve_session_tokens_equal():
    """jamba's session path (its mask folded, equal-length prompts,
    greedy decode) against the reference's."""
    jcfg, tcfg = _cfgs("jamba-v0.1-52b")
    jp = jinit_serve_params(jcfg, jax.random.PRNGKey(0), dtype="float32")
    tp = from_numpy(_np_tree(jp), "cpu")
    jm = jmasks.init_unit_masks(jcfg, 2)
    jm = jax.tree.map(lambda m: m.at[..., ::3].set(0.0), jm)
    tm = from_numpy(_np_tree(jm), "cpu")
    jp = dict(jp, server=jmasks.fold_unit_masks(jcfg, jp["server"], jm, 1))
    tp = dict(tp, server=tmasks.fold_unit_masks(tcfg, tp["server"], tm, 1))
    prompts = np.random.default_rng(3).integers(
        0, jcfg.vocab_size, (2, 10)).astype(np.int32)
    want = np.asarray(jserve.serve_session(jcfg, jp, jnp.asarray(prompts),
                                           5))
    got = tserve.serve_session(tcfg, tp, prompts, 5, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("arch,layers", [("mamba2-370m", 3),
                                         ("jamba-v0.1-52b", 0)])
def test_serve_cli_runs_on_the_cpu(arch, layers, capsys):
    """The session CLI on the reduced config; ``--n-layers`` cuts (here:
    sets) the depth, as jamba's 16 layers on the card."""
    out = tserve.main(["--arch", arch, "--reduced", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "6", "--gen", "3",
                       "--fold-mask", "--n-layers", str(layers)])
    assert out.shape == (2, 3)
    assert ((out >= 0) & (out < get_config(arch).vocab_size)).all()
    assert "folded client 0 mask" in capsys.readouterr().out
