"""The global-phase forms of ``repro_torch.core.adasplit.AdaSplitTrainer``
beyond the default batched step, against the reference trainer
(``round_scan=False``) on the reduced LeNet of ``test_torch_adasplit.py``
(16x16 inputs, conv channels (4, 8, 8)), 3 clients, B=8, the port
starting from the reference's state:

1. teacher-forced: one global iteration from the same state and the same
   selection — the flat joint step (``server_grad_to_client``), the
   per-client joint form (``flat_joint=False``), per-scalar masks with
   the fused epilogue, ``act_l1`` (the joint step keeps only the nnz
   fractions of the client step's activations), serialized server
   updates with and without the joint step — and the per-client loop
   (``global_batch=False``) against the reference's loop;
2. free-running: two rounds of the joint step with the reference's
   tie-break jitter injected, and two rounds of the per-client loop:
   equal selections, CE within 1e-3 relative, exact ``Meter`` totals
   (the activation gradient billed down under the ablation), accuracy
   within one test example per client;
3. the port against itself: the serialized batched step bit-equal to the
   per-client loop (the same ops on the same rows in the same order),
   and the flat joint step within float32 tolerance of the per-client
   form (one forward over S*B rows against a forward stacked over S).

Tolerances are ``test_torch_adasplit.py``'s: state at 1e-4 relative /
1e-5 absolute except at most 0.1% of elements within 2.5*lr (Adam's
early steps are ~lr*sign(g)), meters exact."""
import dataclasses

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
JOINT = dict(server_grad_to_client=True)
MODES = {"joint_flat": JOINT,
         "joint_per_client": dict(JOINT, flat_joint=False),
         "joint_per_scalar_fused": dict(JOINT, mask_mode="per_scalar",
                                        fused_epilogue=True),
         "joint_act_l1": dict(JOINT, act_l1=1e-3),
         "serialized": dict(serialize_server_updates=True),
         "serialized_joint": dict(JOINT, serialize_server_updates=True)}
LR = 1e-3
METER = ("bandwidth_bytes", "client_flops", "server_flops",
         "host_device_bytes", "interconnect_bytes")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The tensors here are small: torch's intra-op threads would only
    contend with each other (and with other processes) on this box."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _clients():
    ref = mixed_noniid(n_clients=3, n_per_client=32, n_test=16, seed=0)
    for c in ref:
        c.x, c.test_x = c.x[:, :16, :16], c.test_x[:, :16, :16]
    port = [ClientData(c.x, c.y, c.test_x, c.test_y, c.dataset_id)
            for c in ref]
    return ref, port


def _tcfg():
    return dataclasses.replace(tget_config("lenet-cifar"), **SMALL)


def _ref_state(tr):
    return jax.tree.map(np.asarray, {
        "client_params": tr.client_params, "proj_params": tr.proj_params,
        "server_params": tr.server_params, "s_opt": tr.s_opt,
        "c_opt": tr.c_opt, "masks": tr.masks, "m_opt": tr.m_opt,
        "ucb": tr.orch.state})


@pytest.fixture(scope="module")
def pair(request):
    """The reference trainer of one mode (built and jitted once per
    module), a reset back to its initial state, and a factory for port
    trainers starting from that state."""
    kw = {**COMMON, **MODES[request.param]}
    ref_clients, port_clients = _clients()
    jcfg = dataclasses.replace(jget_config("lenet-cifar"), **SMALL)
    ref = JTrainer(jcfg, JHParams(round_scan=False, **kw), ref_clients)
    trees = (ref.client_params, ref.proj_params, ref.server_params,
             ref.s_opt, ref.c_opt, ref.masks, ref.m_opt, ref.orch.state)
    meter, hp = dataclasses.replace(ref.meter), ref.hp
    state0 = _ref_state(ref)

    def reset(**hp_kw):
        (ref.client_params, ref.proj_params, ref.server_params, ref.s_opt,
         ref.c_opt, ref.masks, ref.m_opt, ref.orch.state) = trees
        ref.orch._n_selects = 0
        ref.meter = dataclasses.replace(meter)
        ref.history = []
        ref._rng = np.random.default_rng(hp.seed)
        ref.hp = dataclasses.replace(hp, **hp_kw)

    def make_port(hp_kw=(), **extra):
        hp = THParams(**{**kw, "round_scan": False, **dict(hp_kw)})
        port = TTrainer(_tcfg(), hp, port_clients, device="cpu", **extra)
        port.set_state(state0)
        return port

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
    for f in METER:
        assert getattr(a, f) == getattr(b, f), f


def _batch(clients):
    rng = np.random.default_rng(9)
    xs = np.stack([c.x[:8] for c in clients])
    ys = np.stack([c.y[:8] for c in clients])
    return xs + rng.normal(scale=0.01, size=xs.shape).astype(np.float32), ys


def _teacher_forced(ref, port, loop):
    """The client step, then one global iteration on selection [0, 2],
    on both sides; returns both sides' CE losses."""
    xs, ys = _batch(port.clients)
    selected = np.array([0, 2])
    cp_pp = {"c": ref.client_params, "p": ref.proj_params}
    new, ref.c_opt, _, acts_ref = ref._client_step(
        cp_pp, ref.c_opt, jnp.asarray(xs), jnp.asarray(ys))
    ref.client_params, ref.proj_params = new["c"], new["p"]
    ref_step = ref._global_iteration_loop if loop else ref._global_iteration
    ces_ref = ref_step(selected, acts_ref, xs, ys)

    xs_t, ys_t = torch.from_numpy(xs), torch.from_numpy(ys)
    acts, _ = port._client_step(xs_t, ys_t)
    port_step = port._global_iteration_loop if loop \
        else port._global_iteration
    ces = port_step(selected, acts, ys_t, xs_t)
    return ces, ces_ref


@pytest.mark.parametrize("pair", list(MODES), indirect=True)
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


@pytest.mark.parametrize("pair", ["serialized", "serialized_joint"],
                         indirect=True)
def test_loop_teacher_forced_matches_reference_loop(pair):
    """``global_batch=False``: the port's per-client loop against the
    reference's ``_global_iteration_loop``, with and without the joint
    step."""
    ref, make_port, reset = pair
    reset(global_batch=False)
    port = make_port(dict(global_batch=False,
                          serialize_server_updates=False))
    ces, ces_ref = _teacher_forced(ref, port, loop=True)
    np.testing.assert_allclose(ces, ces_ref, rtol=1e-5)
    got, want = port.get_state(), _ref_state(ref)
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


def _free_running(ref, port):
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
    n_test = len(ref.clients[0].test_y)
    accs_ref = np.asarray(ref._eval_all(
        ref.client_params, ref.server_params, ref.masks,
        jnp.asarray(np.stack([c.test_x for c in ref.clients])),
        jnp.asarray(np.stack([c.test_y for c in ref.clients]))))
    assert np.all(np.abs(port.client_accuracies() - accs_ref)
                  <= 1.0 / n_test + 1e-6)


def _jitter(ref):
    def draw(counter, n):
        return np.asarray(jax.random.uniform(
            ref.orch.select_key(counter), (n,), jnp.float32, 0.0, 1.0))
    return draw


@pytest.mark.parametrize("pair", ["joint_flat"], indirect=True)
def test_free_running_joint_rounds_match(pair):
    ref, make_port, reset = pair
    reset()
    port = make_port(jitter=_jitter(ref))
    _free_running(ref, port)
    # the ablation bills the activation gradient down: the payload of a
    # selection is activations + labels up and activations down
    assert port.meter.bandwidth_bytes > 0


@pytest.mark.parametrize("pair", ["serialized", "serialized_joint"],
                         indirect=True)
def test_free_running_loop_rounds_match(pair):
    """``global_batch=False`` free-running on both sides (the reference
    runs its loop whatever ``round_scan`` says)."""
    ref, make_port, reset = pair
    reset(global_batch=False)
    port = make_port(dict(global_batch=False, round_scan=True),
                     jitter=_jitter(ref))
    _free_running(ref, port)


def test_new_hparams_default_as_the_reference():
    t, j = THParams(), JHParams()
    for f in ("server_grad_to_client", "global_batch",
              "serialize_server_updates", "flat_joint"):
        assert getattr(t, f) == getattr(j, f), f


# ---------------------------------------------------------------------------
# 3. the port against itself
# ---------------------------------------------------------------------------


def _port_run(hp_kw, clients):
    tr = TTrainer(_tcfg(), THParams(**dict(COMMON, rounds=3, kappa=0.34,
                                           **hp_kw)),
                  clients, device="cpu")
    sel = _log_updates(tr.orch)
    hist = tr.train(eval_every=3)
    return tr, hist, sel


@pytest.mark.parametrize("extra", [{}, JOINT,
                                   dict(act_l1=1e-3, mask_mode="per_scalar"),
                                   dict(JOINT, act_l1=1e-3)],
                         ids=["plain", "joint", "act_l1_per_scalar",
                              "joint_act_l1"])
def test_serialized_batched_step_bit_equal_to_loop(extra):
    """The serialized batched step runs ``server_step``/``joint_step`` on
    the gathered rows in selection order; the loop runs them on rows
    sliced from the state in the same order: the same ops on the same
    values, so state, selections, CE and meters are bit-equal."""
    _, clients = _clients()
    ser, ser_hist, ser_sel = _port_run(
        dict(extra, round_scan=False, serialize_server_updates=True),
        clients)
    loop, loop_hist, loop_sel = _port_run(dict(extra, global_batch=False),
                                          clients)
    assert ser_hist == loop_hist
    assert len(ser_sel) == len(loop_sel) == 8
    for (s_a, ce_a), (s_b, ce_b) in zip(ser_sel, loop_sel):
        np.testing.assert_array_equal(s_a, s_b)
        np.testing.assert_array_equal(ce_a, ce_b)
    for a, b in zip(tree_leaves(ser.get_state()),
                    tree_leaves(loop.get_state())):
        np.testing.assert_array_equal(a, b)
    _meter_equal(ser.meter, loop.meter)


@pytest.mark.parametrize("pair", ["joint_flat"], indirect=True)
def test_flat_joint_close_to_per_client_joint(pair):
    """One forward over S*B rows against one stacked over S: the same
    function in float32 with other summation orders."""
    _, make_port, _ = pair
    flat, per_client = make_port(), make_port(dict(flat_joint=False))
    xs, ys = (torch.from_numpy(a) for a in _batch(flat.clients))
    out = []
    for tr in (flat, per_client):
        acts, _ = tr._client_step(xs, ys)
        out.append(tr._global_iteration(np.array([0, 2]), acts, ys, xs))
    np.testing.assert_allclose(out[0], out[1], rtol=1e-5)
    got, want = flat.get_state(), per_client.get_state()
    for k in want:
        _state_close(got[k], want[k])
    _meter_equal(flat.meter, per_client.meter)
