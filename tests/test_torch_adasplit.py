"""The slice as a whole: ``repro_torch.core.adasplit.AdaSplitTrainer``
(eager rung) against the reference ``repro.core.adasplit`` trainer with
``round_scan=False``, on a reduced LeNet (16x16 inputs, conv channels
(4, 8, 8)), 3 clients, B=8, both built from the same config fields and
the same numpy data, the port starting from the reference's state.

1. Teacher-forced: one global iteration from the same state and the
   same selection gives the same state and identical ``Meter`` bytes.
2. Free-running: one local and one global round with the reference's
   tie-break jitter injected give equal selections, per-iteration CE
   within tolerance, exact bandwidth/FLOP totals and ``evaluate()``
   within one test example per client — per-unit, per-scalar (with the
   fused epilogue) and act_l1 > 0.
3. No ``repro_torch`` module imports ``jax`` or ``repro``.

Tolerances: one iteration is float32 on both sides with different
summation orders (the port's im2col GEMM and torch reductions vs XLA),
so forwards agree to ~1e-6 relative.  Adam normalises each update by the
gradient's magnitude, so an element whose gradient is a cancellation-
level near-zero can move by up to 2*lr on one side and not the other;
state is therefore held at 1e-4 relative / 1e-5 absolute everywhere
except for at most 0.1% of elements, which may differ by <= 2.5*lr.
Free-running CE drifts further over 8 iterations: 1e-3 relative."""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.core.adasplit import AdaSplitHParams as JHParams
from repro.core.adasplit import AdaSplitTrainer as JTrainer
from repro.data.synthetic import mixed_noniid
from repro_torch.configs.base import get_config as tget_config
from repro_torch.core.adasplit import AdaSplitHParams as THParams
from repro_torch.core.adasplit import AdaSplitTrainer as TTrainer
from repro_torch.data.synthetic import ClientData
from repro_torch.weights import tree_leaves

SMALL = dict(image_size=16, conv_channels=(4, 8, 8))
COMMON = dict(rounds=2, kappa=0.5, eta=0.67, batch_size=8, seed=0)
MODES = {"per_unit": {},
         "per_scalar_fused": dict(mask_mode="per_scalar",
                                  fused_epilogue=True),
         "act_l1": dict(act_l1=1e-3)}
LR = 1e-3


def _clients():
    ref = mixed_noniid(n_clients=3, n_per_client=32, n_test=16, seed=0)
    for c in ref:
        c.x, c.test_x = c.x[:, :16, :16], c.test_x[:, :16, :16]
    port = [ClientData(c.x, c.y, c.test_x, c.test_y, c.dataset_id)
            for c in ref]
    return ref, port


def _ref_state(tr):
    return jax.tree.map(np.asarray, {
        "client_params": tr.client_params, "proj_params": tr.proj_params,
        "server_params": tr.server_params, "s_opt": tr.s_opt,
        "c_opt": tr.c_opt, "masks": tr.masks, "m_opt": tr.m_opt,
        "ucb": tr.orch.state})


def _restore(tr, snap):
    (tr.client_params, tr.proj_params, tr.server_params, tr.s_opt,
     tr.c_opt, tr.masks, tr.m_opt, tr.orch.state) = snap["trees"]
    tr.orch._n_selects = 0
    tr.meter = dataclasses.replace(snap["meter"])
    tr.history = []
    tr._rng = np.random.default_rng(tr.hp.seed)


@pytest.fixture(scope="module", params=list(MODES))
def pair(request):
    """The reference trainer (built and jitted once per mode) and a
    factory for port trainers starting from its initial state."""
    kw = {**COMMON, **MODES[request.param]}
    ref_clients, port_clients = _clients()
    jcfg = dataclasses.replace(jget_config("lenet-cifar"), **SMALL)
    tcfg = dataclasses.replace(tget_config("lenet-cifar"), **SMALL)
    ref = JTrainer(jcfg, JHParams(round_scan=False, global_batch=True, **kw),
                   ref_clients)
    snap = {"trees": (ref.client_params, ref.proj_params, ref.server_params,
                      ref.s_opt, ref.c_opt, ref.masks, ref.m_opt,
                      ref.orch.state),
            "meter": dataclasses.replace(ref.meter)}
    state0 = _ref_state(ref)

    def make_port(**extra):
        port = TTrainer(tcfg, THParams(round_scan=False, **kw), port_clients,
                        device="cpu", **extra)
        port.set_state(state0)
        return port

    def reset():
        _restore(ref, snap)

    return ref, make_port, reset


def _state_close(got, want):
    off, total = 0, 0
    for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
        b = np.asarray(b)
        if b.dtype.kind != "f":
            np.testing.assert_array_equal(a, b)
            continue
        d = np.abs(a.astype(np.float64) - b)
        assert d.max(initial=0.0) <= 2.5 * LR
        off += int(np.sum(d > 1e-5 + 1e-4 * np.abs(b)))
        total += d.size
    assert off <= 1e-3 * total, (off, total)


def _meter_equal(a, b):
    for f in ("bandwidth_bytes", "client_flops", "server_flops",
              "host_device_bytes", "interconnect_bytes"):
        assert getattr(a, f) == getattr(b, f), f


def test_teacher_forced_iteration_matches(pair):
    ref, make_port, reset = pair
    reset()
    port = make_port()
    rng = np.random.default_rng(9)
    xs = np.stack([c.x[:8] for c in port.clients])
    ys = np.stack([c.y[:8] for c in port.clients])
    xs = xs + rng.normal(scale=0.01, size=xs.shape).astype(np.float32)
    selected = np.array([0, 2])

    cp_pp = {"c": ref.client_params, "p": ref.proj_params}
    new, ref.c_opt, closs_ref, acts_ref = ref._client_step(
        cp_pp, ref.c_opt, jnp.asarray(xs), jnp.asarray(ys))
    ref.client_params, ref.proj_params = new["c"], new["p"]
    ces_ref = ref._global_iteration(selected, acts_ref, xs, ys)

    acts, closs = port._client_step(torch.from_numpy(xs),
                                    torch.from_numpy(ys))
    ces = port._global_iteration(selected, acts, torch.from_numpy(ys))

    np.testing.assert_allclose(acts.numpy(), np.asarray(acts_ref),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(closs.numpy(), np.asarray(closs_ref),
                               rtol=1e-5)
    np.testing.assert_allclose(ces, ces_ref, rtol=1e-5)
    got = port.get_state()
    want = _ref_state(ref)
    for k in want:
        _state_close(got[k], want[k])
    _meter_equal(port.meter, ref.meter)


def _log_updates(orch):
    log, update = [], orch.update

    def logged(selected, losses):
        log.append((np.array(selected), np.asarray(losses, np.float64)))
        update(selected, losses)
    orch.update = logged
    return log


def test_free_running_two_rounds_match(pair):
    ref, make_port, reset = pair
    reset()

    def jitter(counter, n):
        return np.asarray(jax.random.uniform(
            ref.orch.select_key(counter), (n,), jnp.float32, 0.0, 1.0))

    port = make_port(jitter=jitter)
    ref_log, port_log = _log_updates(ref.orch), _log_updates(port.orch)
    ref_hist = ref.train(eval_every=2)
    port_hist = port.train(eval_every=2)
    del ref.orch.update                        # drop the logging wrapper

    assert [h["phase"] for h in port_hist] == ["local", "global"]
    assert len(port_log) == len(ref_log) == 4
    for (s_p, ce_p), (s_r, ce_r) in zip(port_log, ref_log):
        np.testing.assert_array_equal(s_p, s_r)
        np.testing.assert_allclose(ce_p, ce_r, rtol=1e-3)
    _meter_equal(port.meter, ref.meter)
    for key in ("bandwidth_gb", "client_tflops", "total_tflops"):
        assert port_hist[-1][key] == ref_hist[-1][key]

    accs_ref = np.asarray(ref._eval_all(
        ref.client_params, ref.server_params, ref.masks,
        jnp.asarray(np.stack([c.test_x for c in ref.clients])),
        jnp.asarray(np.stack([c.test_y for c in ref.clients]))))
    n_test = len(ref.clients[0].test_y)
    assert np.all(np.abs(port.client_accuracies() - accs_ref)
                  <= 1.0 / n_test + 1e-6)
    assert abs(port_hist[-1]["accuracy"] - ref_hist[-1]["accuracy"]) \
        <= 100.0 / n_test + 1e-4


# a five-block reduced LeNet, so that mu 0.2 / 0.5 / 0.75 split after
# conv blocks 1 / 2 / 4, as at full width
FIVE = dict(image_size=32, conv_channels=(4, 8, 8, 8, 8))


@pytest.mark.parametrize("mu,split", [(0.2, 1), (0.5, 2), (0.75, 4)])
def test_free_running_two_rounds_match_at_split_points(mu, split):
    """Split points 1, 2 and 4: one local and one global round from the
    reference's state, its jitter injected: equal selections, CE within
    1e-3 relative, exact meters, state within the Adam sign-flip
    bound."""
    from repro.models import lenet as jlenet
    from repro_torch.models import lenet as tlenet
    ref_clients = mixed_noniid(n_clients=3, n_per_client=32, n_test=16,
                               seed=0)
    port_clients = [ClientData(c.x, c.y, c.test_x, c.test_y, c.dataset_id)
                    for c in ref_clients]
    jcfg = dataclasses.replace(jget_config("lenet-cifar"), mu=mu, **FIVE)
    tcfg = dataclasses.replace(tget_config("lenet-cifar"), mu=mu, **FIVE)
    assert jlenet.split_index(jcfg) == tlenet.split_index(tcfg) == split
    ref = JTrainer(jcfg, JHParams(round_scan=False, **COMMON), ref_clients)

    def jitter(counter, n):
        return np.asarray(jax.random.uniform(
            ref.orch.select_key(counter), (n,), jnp.float32, 0.0, 1.0))

    port = TTrainer(tcfg, THParams(round_scan=False, **COMMON),
                    port_clients, device="cpu", jitter=jitter)
    port.set_state(_ref_state(ref))
    ref_log, port_log = _log_updates(ref.orch), _log_updates(port.orch)
    ref.train(eval_every=2)
    port.train(eval_every=2)
    assert len(port_log) == len(ref_log) == 4
    for (s_p, ce_p), (s_r, ce_r) in zip(port_log, ref_log):
        np.testing.assert_array_equal(s_p, s_r)
        np.testing.assert_allclose(ce_p, ce_r, rtol=1e-3)
    _meter_equal(port.meter, ref.meter)
    got, want = port.get_state(), _ref_state(ref)
    for k in want:
        if k != "ucb":
            _state_close(got[k], want[k])


_IMPORT_ALL = """
import importlib, pkgutil, sys
import repro_torch
mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                              'repro_torch.')]
for m in mods:
    importlib.import_module(m)
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'jaxlib', 'repro', 'msgpack'))
serving = ['configs.qwen2_0_5b', 'models.layers', 'models.mlp',
           'models.attention', 'models.transformer', 'models.decode',
           'kernels.flash_attention', 'launch', 'launch.steps',
           'launch.serve', 'serve', 'serve.lru', 'serve.engine',
           'serve.scheduler', 'serve.continuous', 'baselines',
           'baselines.base', 'baselines.fed', 'baselines.split', 'utils',
           'utils.tree',
           'optim.sgd', 'optim.schedules', 'data.partition',
           'launch.compare', 'checkpoint', 'checkpoint.io',
           'core.client_store', 'data.tokens', 'launch.train',
           'core.losses', 'core.accounting']
missing = [m for m in serving if 'repro_torch.' + m not in mods]
assert len(mods) >= 45 and not missing, (mods, missing)
assert not bad, bad
print(len(mods))
"""


def test_port_imports_no_jax_and_nothing_of_repro():
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=env,
                         cwd=root, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    # chip_smoke.py: no import of jax, jaxlib or repro anywhere in it
    import ast
    tree = ast.parse((root / "chip_smoke.py").read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module or "" for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom)]
    assert not [n for n in names if n.split(".")[0]
                in ("jax", "jaxlib", "repro", "msgpack")], names


def test_evaluate_with_ragged_test_sets_matches_stacked(pair):
    """Clients whose test sets differ in size take the per-client
    evaluation path; each client's accuracy equals the stacked path's."""
    _, make_port, _ = pair
    port = make_port()
    stacked = port.client_accuracies()
    c = port.clients[1]
    port.clients[1] = ClientData(c.x, c.y, c.test_x[:-3], c.test_y[:-3],
                                 c.dataset_id)
    ragged = port.client_accuracies()
    port.clients[1] = c
    np.testing.assert_array_equal(ragged[[0, 2]], stacked[[0, 2]])
    logits = port._eval_logits(port.client_params, port.masks,
                               torch.from_numpy(np.stack([c.test_x] * 3)))
    want = float(np.mean(logits.argmax(-1)[1, :-3].numpy()
                         == c.test_y[:-3]))
    assert ragged[1] == pytest.approx(want)
