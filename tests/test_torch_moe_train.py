"""Port parity: the AdaSplit LM train step of ``repro_torch`` on MoE, SSM
and hybrid stacks, against the JAX package.

One train step of ``reduced()`` deepseek-moe-16b (two MoE layers, the
client's and the server's), qwen3-moe-30b-a3b, jamba-v0.1-52b (``m a m
a``: mamba + dense, attention + MoE on each side) and mamba2-370m (one
mamba layer a side), from the reference's ``init_train_state``, against
the mesh-free oracle of ``tests/test_torch_lm_train.py`` (the
reference's ``micro_loss`` and ``train_step`` composed from its own
functions under a plain ``jax.vmap``, with ``router_aux_coef * aux`` in
the server loss), with ``remat`` on and off.  The loss terms (client
NT-Xent, CE and the server's router aux loss), every gradient, the Adam
moments and the updated params are held to that file's float32
tolerances: losses to 1e-5 relative, gradients and moments to 5e-5 of
each leaf's largest magnitude, and at most 1e-3 of the elements' first
Adam moves more than 1e-3 lr apart.  The reference's aux is computed
with its own ``client_forward`` and ``server_forward``.

The router's gradient carries ``router_aux_coef`` times the aux loss's:
deepseek's step at coefficient 0 and at 1 gives router gradients that
differ, each equal to the oracle's at the same coefficient.
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
from repro.launch.steps import init_train_state as jinit_train_state
from repro.models import transformer as jtfm
from repro_torch.configs.base import InputShape, get_config
from repro_torch.launch import steps as tsteps
from repro_torch.models import attention as tattn
from repro_torch.weights import train_state_from_numpy, to_numpy, tree_leaves
from test_torch_lm_train import (S, SEED, _batch, _close_tree, _close_update,
                                 _np, _refuse_flash, oracle_step)

ARCHS = ("deepseek-moe-16b", "qwen3-moe-30b-a3b", "jamba-v0.1-52b",
         "mamba2-370m")
C, b = 2, 4


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The tensors here are small: torch's intra-op threads would only
    contend with each other (and with other processes) on a CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def no_flash(monkeypatch):
    monkeypatch.setattr(tattn, "flash_attention", _refuse_flash)


def _cfgs(arch, **kw):
    kw = dict(dtype="float32", **kw)
    return (dataclasses.replace(jget_config(arch).reduced(), **kw),
            dataclasses.replace(get_config(arch).reduced(), **kw))


def _ref_aux(cfg, state, batch):
    """The reference's server router aux loss of the step's batch: its
    own ``client_forward`` per cohort, then ``server_forward`` with each
    row's cohort gates (jitted, as the oracle is)."""
    def aux(tr, tokens):
        toks = tokens.reshape(C, b, S)
        acts = jnp.stack([jtfm.client_forward(
            cfg, jax.tree.map(lambda t: t[c], tr["client"]["model"]),
            toks[c]) for c in range(C)]).reshape(C * b, S, -1)
        gates = jmasks.expand_gates(tr["masks"],
                                    jnp.repeat(jnp.arange(C), b))
        return jtfm.server_forward(cfg, tr["server"], acts, tokens,
                                   gates=gates, return_hidden=True)[1]
    return float(jax.jit(aux)(state["trainables"],
                              jnp.asarray(batch["tokens"])))


@pytest.fixture(scope="module")
def oracle_runs():
    """(initial state, batch, new state, metrics, aux) per (arch, coef),
    computed once."""
    cache = {}

    def get(arch, coef=None):
        key = (arch, coef)
        if key not in cache:
            kw = {} if coef is None else {"router_aux_coef": coef}
            jcfg, _ = _cfgs(arch, **kw)
            pol = JPolicy(microbatch=1, remat=False, param_dtype="float32")
            state = jinit_train_state(jcfg, C, pol, jax.random.PRNGKey(SEED))
            batch = _batch(C, b, "global")
            new, m = jax.jit(oracle_step(jcfg, C, C * b, pol))(state, batch)
            cache[key] = (_np(state), batch, _np(new), _np(m),
                          _ref_aux(jcfg, state, batch))
        return cache[key]
    return get


def _port_step(arch, state_np, batch, remat, monkeypatch, **kw):
    _, tcfg = _cfgs(arch, **kw)
    pol = tsteps.LaunchPolicy(microbatch=1, remat=remat,
                              param_dtype="float32")
    like = tsteps.init_train_state(tcfg, C, pol, SEED, device="cpu")
    state = train_state_from_numpy(state_np, "cpu", like=like)
    seen = {}
    adam = tsteps.adam_update

    def spy(params, grads, opt, *, lr):
        seen["grads"] = grads
        return adam(params, grads, opt, lr=lr)
    monkeypatch.setattr(tsteps, "adam_update", spy)
    fn = tsteps.build_train_step(tcfg, InputShape("t", S, C * b, "train"),
                                 pol, n_cohorts=C)
    new, m = fn(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    return to_numpy(new), m, to_numpy(seen["grads"])


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no_remat"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch, remat, oracle_runs, monkeypatch,
                                      no_flash):
    state0, batch, want, wm, waux = oracle_runs(arch)
    got, m, grads = _port_step(arch, state0, batch, remat, monkeypatch)
    np.testing.assert_allclose(float(m["l_client"]), wm["l_client"],
                               rtol=1e-5)
    np.testing.assert_allclose(float(m["ce"]), wm["ce"], rtol=1e-5)
    if get_config(arch).n_experts:
        assert waux > 0.5                # top-1 density x mean prob x E
        np.testing.assert_allclose(float(m["aux"]), waux, rtol=1e-5)
    else:
        assert float(m["aux"]) == 0.0 == waux
    _close_tree(grads, wm["grads"], "float32", "grad")
    _close_tree(got["opt"]["mu"], want["opt"]["mu"], "float32", "mu")
    _close_tree(got["opt"]["nu"], want["opt"]["nu"], "float32", "nu")
    assert int(got["opt"]["step"]) == int(want["opt"]["step"]) == 1
    _close_update(got["trainables"], want["trainables"],
                  state0["trainables"], "float32")


def _router_grads(grads):
    """The server's router gradients, in segment and body order."""
    return [layer["ffn"]["router"] for seg in grads["server"]["segments"]
            for layer in seg if "router" in layer.get("ffn", {})]


def test_router_gradient_follows_the_aux_coefficient(oracle_runs,
                                                     monkeypatch):
    """At ``router_aux_coef`` 0 and 1 the step's server router gradients
    differ (only the aux term's share moves), and each equals the
    oracle's at the same coefficient; a loss that added the aux without
    its coefficient would match neither at 0."""
    got = {}
    for coef in (0.0, 1.0):
        state0, batch, _, wm, _ = oracle_runs("deepseek-moe-16b", coef)
        _, _, grads = _port_step("deepseek-moe-16b", state0, batch, True,
                                 monkeypatch, router_aux_coef=coef)
        got[coef] = _router_grads(grads)
        want = _router_grads(wm["grads"])
        assert len(got[coef]) == len(want) >= 1
        _close_tree(got[coef], want, "float32", f"router grad coef {coef}")
    for a, z in zip(got[1.0], got[0.0]):
        assert np.abs(a - z).max() > 1e-3 * np.abs(a).max()


@pytest.mark.parametrize("arch", ARCHS)
def test_init_train_state_structure_matches_reference(arch):
    """Under the default policy (bf16 large leaves, f32 moments and
    masks) the port's train state is the reference's leaf for leaf:
    shapes and dtypes, in the reference's leaf order."""
    jcfg, tcfg = (dataclasses.replace(c, dtype="bfloat16")
                  for c in _cfgs(arch))
    want = jax.eval_shape(lambda: jinit_train_state(
        jcfg, C, JPolicy(), jax.random.PRNGKey(SEED)))
    got = tsteps.init_train_state(tcfg, C, tsteps.LaunchPolicy(), SEED,
                                  device="cpu")
    assert [(tuple(t.shape), str(t.dtype).replace("torch.", ""))
            for t in tree_leaves(got)] == \
        [(w.shape, str(w.dtype)) for w in jax.tree.leaves(want)]
