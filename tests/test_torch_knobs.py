"""The trainer's last three knobs against the reference's same settings:
``batched_conv`` (False: every conv through the library conv, the
reference's ``_conv_reference`` / ``lax.conv_general_dilated`` path) and
``fused_mask_adam`` / ``fused_server_adam`` (False: ``adam_update``'s
rounding order for the masks / the server, which is what the reference
runs on the CPU whatever the flags say).

1. Forwards: the LeNet client tower (one client, and stacked) and the
   server half (per-example gates, and per-client stacked weights) with
   ``batched_conv=False`` against the reference's, values and
   gradients.
2. Teacher-forced: one global iteration from the reference's state on
   the same selection, and free-running: two rounds with the reference's
   tie-break jitter, for ``batched_conv=False`` (per-unit, and per-scalar
   with the fused epilogue) and both Adam flags False (per-unit and
   per-scalar).
3. The port alone: ``batched_conv=False`` reaches no panel GEMM; the
   Adam flags at True run what None runs, bit for bit.

Tolerances are ``test_torch_adasplit.py``'s (values 1e-5, gradients
1e-4; state 1e-4 relative / 1e-5 absolute but for at most 0.1% of
elements within 2.5*lr; CE 1e-5 teacher-forced, 1e-3 free-running;
meters exact).  Reduced LeNet (16x16, conv channels (4, 8, 8)), 3
clients, B=8."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.core.adasplit import AdaSplitHParams as JHParams
from repro.core.adasplit import AdaSplitTrainer as JTrainer
from repro.models import lenet as jlenet
from repro_torch.core.adasplit import AdaSplitHParams as THParams
from repro_torch.core.adasplit import AdaSplitTrainer as TTrainer
from repro_torch.kernels import client_conv as tcc
from repro_torch.models import lenet as tlenet
from repro_torch.weights import from_numpy, tree_leaves
from test_torch_joint import (COMMON, SMALL, _clients, _free_running,
                              _jitter, _meter_equal, _ref_state,
                              _state_close, _tcfg, _teacher_forced)

MODES = {"conv_ref": dict(batched_conv=False),
         "conv_ref_per_scalar_fused": dict(batched_conv=False,
                                           mask_mode="per_scalar",
                                           fused_epilogue=True),
         "adam_unfused": dict(fused_mask_adam=False,
                              fused_server_adam=False),
         "adam_unfused_per_scalar": dict(fused_mask_adam=False,
                                         fused_server_adam=False,
                                         mask_mode="per_scalar")}
RNG = np.random.default_rng(11)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, tol):
    for a, b in zip(tree_leaves(got), want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol,
                                   atol=tol)


# ---------------------------------------------------------------------------
# 1. forwards
# ---------------------------------------------------------------------------


def test_client_forward_conv_reference_matches():
    jc = dataclasses.replace(jget_config("lenet-cifar"), **SMALL)
    tc = _tcfg()
    C, B = 3, 2
    cps = [jax.tree.map(np.asarray, jlenet.init_client_params(
        jc, jax.random.PRNGKey(i))) for i in range(C)]
    stacked = jax.tree.map(lambda *l: np.stack(l), *cps)
    x = RNG.random(size=(C, B, 16, 16, 3)).astype(np.float32)
    want = jlenet.client_forward(jc, cps[0], jnp.asarray(x[0]),
                                 batched_conv=False)
    got = tlenet.client_forward(tc, from_numpy(cps[0], "cpu"),
                                torch.from_numpy(x[0]), batched_conv=False)
    _close([got], [want], 1e-5)
    want = jax.vmap(lambda p, x: jlenet.client_forward(
        jc, p, x, batched_conv=False))(stacked, jnp.asarray(x))
    for fused in (False, True):
        got = tlenet.client_forward(tc, from_numpy(stacked, "cpu"),
                                    torch.from_numpy(x), batched_conv=False,
                                    fused_epilogue=fused)
        _close([got], [want], 1e-5)


@pytest.mark.parametrize("stacked", [False, True],
                         ids=["per_example_gates", "stacked_weights"])
def test_server_forward_conv_reference_and_grads_match(stacked):
    jc = dataclasses.replace(jget_config("lenet-cifar"), **SMALL)
    tc = _tcfg()
    S, B = 3, 2
    sps = [jax.tree.map(np.asarray, jlenet.init_server_params(
        jc, jax.random.PRNGKey(i))) for i in range(S)]
    if stacked:
        sp = jax.tree.map(lambda *l: np.stack(l), *sps)
        acts = RNG.random(size=(S, B, 8, 8, 4)).astype(np.float32)
        gates = None
    else:
        sp = sps[0]
        acts = RNG.random(size=(S * B, 8, 8, 4)).astype(np.float32)
        gates = {"blocks": [RNG.uniform(0.5, 1.5, (S * B, u)).astype(
            np.float32) for u in (8, 8)],
            "fc1": RNG.uniform(0.5, 1.5, (S * B, 120)).astype(np.float32),
            "fc2": RNG.uniform(0.5, 1.5, (S * B, jc.d_model)).astype(
                np.float32)}
    r = RNG.normal(size=acts.shape[:-3] + (jc.n_classes,)).astype(np.float32)

    def jf(sp, acts):
        if stacked:
            logits = jax.vmap(lambda p, a: jlenet.server_forward(
                jc, p, a, batched_conv=False)[0])(sp, acts)
        else:
            logits = jlenet.server_forward(
                jc, sp, acts, gates=jax.tree.map(jnp.asarray, gates),
                batched_conv=False)[0]
        return jnp.sum(logits * r), logits

    (_, want), want_g = jax.value_and_grad(jf, argnums=(0, 1),
                                           has_aux=True)(
        jax.tree.map(jnp.asarray, sp), jnp.asarray(acts))
    tsp = from_numpy(sp, "cpu")
    ta = torch.from_numpy(acts)
    leaves = tree_leaves(tsp) + [ta]
    for t in leaves:
        t.requires_grad_(True)
    logits, _ = tlenet.server_forward(
        tc, tsp, ta, gates=None if gates is None else from_numpy(gates,
                                                                  "cpu"),
        batched_conv=False)
    _close([logits.detach()], [want], 1e-5)
    grads = torch.autograd.grad((logits * torch.from_numpy(r)).sum(),
                                leaves)
    _close(grads, jax.tree.leaves(want_g[0]) + [want_g[1]], 1e-4)


# ---------------------------------------------------------------------------
# 2. the trainer against the reference's same settings
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=list(MODES))
def pair(request):
    """The reference trainer of one mode (built once), a reset back to its
    initial state, and a factory for port trainers from that state."""
    kw = {**COMMON, **MODES[request.param]}
    ref_clients, port_clients = _clients()
    jcfg = dataclasses.replace(jget_config("lenet-cifar"), **SMALL)
    ref = JTrainer(jcfg, JHParams(round_scan=False, **kw), ref_clients)
    trees = (ref.client_params, ref.proj_params, ref.server_params,
             ref.s_opt, ref.c_opt, ref.masks, ref.m_opt, ref.orch.state)
    meter = dataclasses.replace(ref.meter)
    state0 = _ref_state(ref)

    def reset():
        (ref.client_params, ref.proj_params, ref.server_params, ref.s_opt,
         ref.c_opt, ref.masks, ref.m_opt, ref.orch.state) = trees
        ref.orch._n_selects = 0
        ref.meter = dataclasses.replace(meter)
        ref.history = []
        ref._rng = np.random.default_rng(ref.hp.seed)

    def make_port(**extra):
        port = TTrainer(_tcfg(), THParams(**{**kw, "round_scan": False}),
                        port_clients, device="cpu", **extra)
        port.set_state(state0)
        return port

    return ref, make_port, reset


def test_teacher_forced_iteration_matches(pair):
    ref, make_port, reset = pair
    reset()
    port = make_port()
    ces, ces_ref = _teacher_forced(ref, port, loop=False)
    np.testing.assert_allclose(ces, ces_ref, rtol=1e-5)
    got, want = port.get_state(), _ref_state(ref)
    for k in want:
        _state_close(got[k], want[k])
    _meter_equal(port.meter, ref.meter)


def test_free_running_two_rounds_match(pair):
    ref, make_port, reset = pair
    reset()
    port = make_port(jitter=_jitter(ref))
    _free_running(ref, port)


# ---------------------------------------------------------------------------
# 3. the port alone
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("batched", [True, False])
def test_conv_reference_reaches_no_panel_gemm(monkeypatch, batched):
    calls = []
    plain = tcc.panel_gemm_plain

    def counted(*args, **kw):
        calls.append(1)
        return plain(*args, **kw)
    monkeypatch.setattr(tcc, "panel_gemm_plain", counted)
    _, clients = _clients()
    tr = TTrainer(_tcfg(), THParams(**{**COMMON, "batched_conv": batched,
                                       "kappa": 0.0, "rounds": 1}),
                  clients, device="cpu")
    tr.train(eval_every=1)
    assert (len(calls) > 0) == batched


@pytest.mark.parametrize("mode", ["per_unit", "per_scalar"])
def test_adam_flags_true_run_what_none_runs(mode):
    _, clients = _clients()
    states = []
    for flag in (None, True):
        tr = TTrainer(_tcfg(), THParams(**{**COMMON, "mask_mode": mode,
                                           "fused_mask_adam": flag,
                                           "fused_server_adam": flag}),
                      clients, device="cpu")
        tr.train(eval_every=2)
        states.append(tr.get_state())
    for a, b in zip(tree_leaves(states[0]), tree_leaves(states[1])):
        np.testing.assert_array_equal(a, b)
