"""The port's round and epoch rungs of ``AdaSplitTrainer``.

1. Against the reference: the port's round rung (the default,
   ``round_scan=True``) against the JAX round rung from the same state,
   the reference's tie-break jitter injected: equal selections, exact
   ``Meter`` totals, per-iteration CE within 1e-3 relative (the
   tolerance of ``test_torch_adasplit.py``: float32 on both sides with
   other summation orders, drifting over the run's iterations).
2. Against the port's eager rung (``round_scan=False``): the round rung
   and the epoch rung (``epoch_chunk_rounds`` 0, 1, 2) run the same torch
   ops in the same order, so the state is bit-equal, the selections and
   ``orch.L``/``orch.S`` equal, the history records equal — the joint
   step and the serialized joint step included.
3. Host syncs: one fetch per global round (round rung) and per global
   epoch (epoch rung), none in local ones, counted at the trainer's one
   fetch point ``_fetch``; the joint and serialized steps add none.
4. Empty rounds (T == 0) still reset the bandit; eval points cut epochs.
5. ``Meter.ingest_round``/``ingest_epoch`` against per-event billing, and
   the port's ``Orchestrator`` histories against the reference's.

Reduced LeNet (16x16 inputs, conv channels (4, 8, 8)), B=8."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.core import orchestrator as jorch
from repro.core.adasplit import AdaSplitHParams as JHParams
from repro.core.adasplit import AdaSplitTrainer as JTrainer
from repro.data.synthetic import mixed_noniid
from repro_torch.configs.base import get_config as tget_config
from repro_torch.core import orchestrator as torch_orch
from repro_torch.core.accounting import Meter, split_payload_bytes
from repro_torch.core.adasplit import AdaSplitHParams as THParams
from repro_torch.core.adasplit import AdaSplitTrainer as TTrainer
from repro_torch.data.synthetic import ClientData
from repro_torch.weights import tree_leaves

SMALL = dict(image_size=16, conv_channels=(4, 8, 8))
MODES = {"per_unit": {},
         "per_scalar_fused": dict(mask_mode="per_scalar",
                                  fused_epilogue=True),
         "act_l1": dict(act_l1=1e-3),
         "joint": dict(server_grad_to_client=True),
         "serialized_joint": dict(server_grad_to_client=True,
                                  serialize_server_updates=True)}
RUNGS = {"round": {},
         "epoch_chunk0": dict(epoch_scan=True),
         "epoch_chunk1": dict(epoch_scan=True, epoch_chunk_rounds=1),
         "epoch_chunk2": dict(epoch_scan=True, epoch_chunk_rounds=2)}
# the one-fetch test's rungs: RUNGS, and the joint and serialized global
# steps on them
FETCH_RUNGS = {**RUNGS,
               "round_joint": dict(server_grad_to_client=True),
               "epoch_chunk1_joint": dict(epoch_scan=True,
                                          epoch_chunk_rounds=1,
                                          server_grad_to_client=True),
               "round_serialized_joint": dict(
                   server_grad_to_client=True,
                   serialize_server_updates=True)}
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


def _clients(n=3, n_per_client=32):
    ref = mixed_noniid(n_clients=n, n_per_client=n_per_client, n_test=16,
                       seed=0)
    for c in ref:
        c.x, c.test_x = c.x[:, :16, :16], c.test_x[:, :16, :16]
    port = [ClientData(c.x, c.y, c.test_x, c.test_y, c.dataset_id)
            for c in ref]
    return ref, port


def _tcfg():
    return dataclasses.replace(tget_config("lenet-cifar"), **SMALL)


def _port(hp_kw, clients, **extra):
    return TTrainer(_tcfg(), THParams(**hp_kw), clients, device="cpu",
                    **extra)


def _meter_equal(a, b):
    for f in METER:
        assert getattr(a, f) == getattr(b, f), f


def _log_ingests(orch):
    """Record every (selection, losses) row a rung hands the
    orchestrator."""
    log, ingest = [], orch.ingest_round

    def logged(sel_idx, losses, state=None):
        log.extend(zip(np.array(sel_idx), np.array(losses, np.float64)))
        ingest(sel_idx, losses, state=state)
    orch.ingest_round = logged
    return log


# ---------------------------------------------------------------------------
# 1. the port's round rung against the JAX round rung
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["per_unit", "act_l1"])
def test_round_rung_matches_reference_round_rung(mode):
    kw = dict(rounds=2, kappa=0.5, eta=0.67, batch_size=8, seed=0,
              **MODES[mode])
    ref_clients, port_clients = _clients()
    jcfg = dataclasses.replace(jget_config("lenet-cifar"), **SMALL)
    ref = JTrainer(jcfg, JHParams(round_scan=True, global_batch=True, **kw),
                   ref_clients)
    state0 = jax.tree.map(np.asarray, {
        "client_params": ref.client_params, "proj_params": ref.proj_params,
        "server_params": ref.server_params, "s_opt": ref.s_opt,
        "c_opt": ref.c_opt, "masks": ref.masks, "m_opt": ref.m_opt,
        "ucb": ref.orch.state})

    def jitter(counter, n):
        return np.asarray(jax.random.uniform(
            ref.orch.select_key(counter), (n,), jnp.float32, 0.0, 1.0))

    port = _port(kw, port_clients, jitter=jitter)
    assert port.hp.round_scan and not port.hp.epoch_scan
    port.set_state(state0)
    ref_log, port_log = _log_ingests(ref.orch), _log_ingests(port.orch)
    ref_hist = ref.train(eval_every=2)
    port_hist = port.train(eval_every=2)

    assert [h["phase"] for h in port_hist] == ["local", "global"]
    assert len(port_log) == len(ref_log) == 4
    for (s_p, ce_p), (s_r, ce_r) in zip(port_log, ref_log):
        np.testing.assert_array_equal(s_p, s_r)
        np.testing.assert_allclose(ce_p, ce_r, rtol=1e-3)
    _meter_equal(port.meter, ref.meter)
    np.testing.assert_array_equal(port.orch.S, ref.orch.S)
    np.testing.assert_allclose(port.orch.L, ref.orch.L, rtol=1e-3)
    assert port.orch._n_selects == ref.orch._n_selects == 4
    for key in ("bandwidth_gb", "client_tflops", "total_tflops",
                "host_device_gb"):
        assert port_hist[-1][key] == ref_hist[-1][key]
    n_test = len(ref_clients[0].test_y)
    assert abs(port_hist[-1]["accuracy"] - ref_hist[-1]["accuracy"]) \
        <= 100.0 / n_test + 1e-4


# ---------------------------------------------------------------------------
# 2. round and epoch rungs against the port's eager rung
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def eager_runs():
    """The eager rung's run per mode, made once: (hparams, trainer,
    history, its selections)."""
    _, clients = _clients(n=4, n_per_client=24)
    out = {}
    for mode, extra in MODES.items():
        kw = dict(rounds=5, kappa=0.4, eta=0.5, batch_size=8, **extra)
        tr = _port(dict(kw, round_scan=False), clients)
        sel_log = []
        update = tr.orch.update

        def logged(selected, losses, update=update, log=sel_log):
            log.append(np.array(selected))
            update(selected, losses)
        tr.orch.update = logged
        hist = tr.train(eval_every=3)
        out[mode] = (kw, tr, hist, sel_log, clients)
    return out


@pytest.mark.parametrize("rung", list(RUNGS))
@pytest.mark.parametrize("mode", list(MODES))
def test_rung_bit_equal_to_eager_rung(eager_runs, mode, rung):
    kw, eager, eager_hist, eager_sel, clients = eager_runs[mode]
    tr = _port(dict(kw, **RUNGS[rung]), clients)
    log = _log_ingests(tr.orch)
    hist = tr.train(eval_every=3)
    assert hist == eager_hist
    assert len(log) == len(eager_sel) == 9
    for (s, _), s_eager in zip(log, eager_sel):
        np.testing.assert_array_equal(s, s_eager)
    for a, b in zip(tree_leaves(tr.get_state()),
                    tree_leaves(eager.get_state())):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tr.orch.L, eager.orch.L)
    np.testing.assert_array_equal(tr.orch.S, eager.orch.S)
    assert tr.orch._n_selects == eager.orch._n_selects
    _meter_equal(tr.meter, eager.meter)


def test_round_rung_is_the_default():
    hp = THParams()
    assert hp.round_scan is True and hp.epoch_scan is False
    assert hp.epoch_chunk_rounds == 0
    assert JHParams().round_scan is hp.round_scan


# ---------------------------------------------------------------------------
# 3. one fetch per global round / epoch, none in local ones
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rung,kappa,want", [
    ("round", 0.5, [2, 3]),          # rounds 2, 3 global: one fetch each
    ("epoch_chunk0", 0.5, [2]),      # one global epoch (rounds 2-3)
    ("epoch_chunk1", 0.5, [2]),      # chunking does not add fetches
    ("round", 1.0, [4]),             # all local: the client losses once,
    ("epoch_chunk2", 1.0, [4]),      # after the last round
    ("round_joint", 0.5, [2, 3]),    # the joint and serialized steps
    ("epoch_chunk1_joint", 0.5, [2]),  # read nothing more
    ("round_serialized_joint", 0.5, [2, 3]),
])
def test_one_fetch_per_global_round_or_epoch(monkeypatch, rung, kappa,
                                             want):
    _, clients = _clients()
    tr = _port(dict(rounds=4, kappa=kappa, eta=0.67, batch_size=8,
                    **FETCH_RUNGS[rung]), clients)
    at, fetch = [], TTrainer._fetch

    def counting(self, tensors):
        at.append(len(self.history))     # records made before this fetch
        return fetch(self, tensors)
    monkeypatch.setattr(TTrainer, "_fetch", counting)
    hist = tr.train(eval_every=100)
    assert at == want
    assert all(np.isfinite(h["client_loss"]) for h in hist)


# ---------------------------------------------------------------------------
# 4. empty rounds, eval cadence
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rung", ["eager", "round", "epoch_chunk0"])
def test_empty_rounds_still_reset_the_bandit(rung):
    """Clients with fewer examples than a batch: T == 0, nothing to run,
    but every round still opens with ``ucb_new_round``."""
    _, clients = _clients(n_per_client=4)
    kw = dict(RUNGS.get(rung, {}), round_scan=rung != "eager")
    tr = _port(dict(rounds=3, kappa=0.34, eta=0.67, batch_size=8, **kw),
               clients)
    tr.orch.update([0, 2], [3.0, 0.5])          # a state a reset changes
    want = tr.orch.state
    for _ in range(3):
        want = torch_orch.ucb_new_round(want, gamma=tr.orch.gamma)
    hist = tr.train(eval_every=1)
    for k in want:
        assert torch.equal(tr.orch.state[k], want[k]), k
    np.testing.assert_array_equal(tr.orch.S, np.ones((3, 2)))
    assert [h["client_loss"] for h in hist] == [0.0] * 3
    assert [h["ce"] for h in hist] == [None] * 3
    assert tr.meter.client_flops == 0.0


def test_eval_points_cut_epochs(monkeypatch):
    _, clients = _clients()
    tr = _port(dict(rounds=5, kappa=0.4, eta=0.67, batch_size=8,
                    epoch_scan=True), clients)
    epochs, run = [], TTrainer._run_epoch_scan

    def logged(self, rounds_data, T, global_phase):
        epochs.append((len(rounds_data), global_phase))
        return run(self, rounds_data, T, global_phase)
    monkeypatch.setattr(TTrainer, "_run_epoch_scan", logged)
    hist = tr.train(eval_every=2)
    assert epochs == [(2, False), (2, True), (1, True)]
    assert [("accuracy" in h) for h in hist] == [False, True, False, True,
                                                 True]
    assert [h["round"] for h in hist] == list(range(5))


# ---------------------------------------------------------------------------
# 5. Meter and Orchestrator ingestion
# ---------------------------------------------------------------------------


def _bill(m, acts_shape, batch, n, fl_c, fl_s, fracs):
    """The eager rung's per-event billing of one round."""
    for t in range(fracs.shape[0]):
        m.add_client_flops(3 * fl_c * n * batch)
        for j in range(fracs.shape[1]):
            m.add_payload(split_payload_bytes(
                acts_shape, batch, nnz_fraction=float(fracs[t, j])))
            m.add_server_flops(3 * fl_s * batch)


def test_meter_ingest_round_and_epoch_match_per_event_billing():
    acts_shape, batch, n, T, k, R = (8, 4, 4, 8), 8, 5, 3, 2, 3
    fl_c, fl_s = 1.25e6, 3.5e5
    fracs = np.random.default_rng(0).uniform(0.05, 1.0, (R, T, k))
    kw = dict(acts_shape=acts_shape, batch=batch, n_clients=n, n_iters=T,
              client_flops_per_example=fl_c, server_flops_per_example=fl_s,
              host_device_bytes=1234.0)
    per_round, per_epoch, manual = Meter(), Meter(), Meter()
    for r in range(R):
        per_round.ingest_round(nnz_fracs=fracs[r], **kw)
        _bill(manual, acts_shape, batch, n, fl_c, fl_s, fracs[r])
        manual.add_host_device(1234.0)
    summaries = per_epoch.ingest_epoch(n_rounds=R, nnz_fracs=fracs, **kw)
    _meter_equal(per_round, manual)
    _meter_equal(per_epoch, manual)
    assert summaries[-1] == manual.summary() and len(summaries) == R
    dense = Meter()
    dense.ingest_epoch(n_rounds=2, n_selected=k, **kw)
    assert dense.bandwidth_bytes == 2 * T * k * split_payload_bytes(
        acts_shape, batch)


def test_orchestrator_ingestion_matches_reference_histories():
    n, eta, T, R = 7, 0.43, 4, 3
    ref = jorch.Orchestrator(n, eta, gamma=0.87, seed=1)
    port = torch_orch.Orchestrator(n, eta, gamma=0.87, seed=1,
                                   device="cpu")
    eager = torch_orch.Orchestrator(n, eta, gamma=0.87, seed=1,
                                    device="cpu")
    rng = np.random.default_rng(3)
    sel = np.sort(np.stack([np.stack([rng.choice(n, ref.k, replace=False)
                                      for _ in range(T)])
                            for _ in range(R)]), axis=-1)
    losses = rng.uniform(0.2, 3.0, sel.shape).astype(np.float32)
    # one round: replayed without a state, then as an epoch with one
    ref.new_round()
    port.new_round()
    eager.new_round()
    ref.ingest_round(sel[0], losses[0])
    port.ingest_round(sel[0], losses[0])
    for t in range(T):
        eager.update(sel[0, t], losses[0, t])
    final = port.state
    ref.ingest_epoch(sel[1:], losses[1:], state=ref.state)
    port.ingest_epoch(sel[1:], losses[1:], state=final)
    for r in (1, 2):
        eager.new_round()
        for t in range(T):
            eager.update(sel[r, t], losses[r, t])
    np.testing.assert_allclose(port.L, ref.L, rtol=1e-6)
    np.testing.assert_array_equal(port.S, ref.S)
    np.testing.assert_array_equal(port.L, eager.L)
    np.testing.assert_array_equal(port.S, eager.S)
    np.testing.assert_allclose(port.advantage(), ref.advantage(), rtol=1e-6)
    assert port._n_selects == ref._n_selects == R * T
    assert port.state is final
    # a local epoch only resets the histories and adopts the state
    port.ingest_epoch(None, None, state=eager.state, n_rounds=2)
    np.testing.assert_array_equal(port.L, np.repeat(eager.L[:, -1:], 2, 1))
    np.testing.assert_array_equal(port.S, np.ones((n, 2)))


def test_jitter_schedule_equals_per_select_draws():
    a = torch_orch.Orchestrator(9, 0.5, seed=4, device="cpu")
    sched = a.jitter_schedule(3, 5)
    assert tuple(sched.shape) == (5, 9) and sched.dtype == torch.float32
    for t in range(5):
        assert torch.equal(sched[t], a.jitter(3 + t, 9))
    assert tuple(a.jitter_schedule(0, 0).shape) == (0, 9)
