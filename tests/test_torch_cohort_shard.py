"""Cohort-sharded training of the port (``shard_clients=True``) over
``torch.distributed``: 2 gloo ranks on the CPU against the port's own
unsharded run.

The reference's sharded run cannot run here (its in-process tests need 8
emulated devices, and its subprocess differential fails on this host),
so the sharded port is held to the unsharded port, which the other test
files hold to the reference, with the reference's tolerances
(``tests/test_cohort_shard.py``): selections and ``_n_selects`` exact,
bandwidth and FLOPs exact (``act_l1`` at rtol 1e-4), CE history within
1e-5, final server, client and mask params within 1e-4 (1e-3 for the
joint step), ``evaluate()`` within 1e-3.  Beside those: interconnect
equals the reference's formula, is > 0, and is exactly the bytes the
exchange moved; the server ends bit-equal on both ranks; a streamed
sharded run bills no interconnect and the streamed run's host traffic.

One module-scoped job of 2 spawned ranks runs every case (rendezvous
through a ``file://`` store in ``tmp_path``, so files running side by
side never share a port), bounded by its own timeout; the unsharded
runs are made in this process.  The ranks run ``torch_cohort_job.py``.
"""
import warnings

import numpy as np
import pytest
import torch

import torch_cohort_job as job
from repro_torch.core.adasplit import AdaSplitHParams, AdaSplitTrainer
from repro_torch.launch.distributed import run_ranks
from repro_torch.launch.mesh import make_cohort_mesh
from repro_torch.weights import tree_leaves

JOB_TIMEOUT_S = 240.0
SHARDED = [c for c in job.CASES if c != "non_divisible"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both ranks' results of every case."""
    d = tmp_path_factory.mktemp("cohort")
    return run_ranks(job.job, 2, backend="gloo", args=(str(d),),
                     timeout=JOB_TIMEOUT_S)


@pytest.fixture(scope="module")
def unsharded(tmp_path_factory):
    d = tmp_path_factory.mktemp("unsharded")
    runs = {}

    def get(label):
        if label not in runs:
            runs[label] = job.train(label, False, f"{d}/{label}")
        return runs[label]
    return get


def _max_diff(a, b):
    return max(float(np.abs(np.asarray(x, np.float64)
                            - np.asarray(y, np.float64)).max())
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def _n_global_iterations(label):
    kw = {**job.DEFAULTS, **job.CASES[label][0]}
    T = 32 // kw["batch_size"]
    return (kw["rounds"] - int(round(kw["kappa"] * kw["rounds"]))) * T


@pytest.mark.parametrize("label", SHARDED)
def test_sharded_matches_unsharded(ranks, unsharded, label):
    sh, ref = ranks[0][label], unsharded(label)
    assert sh["shard"] and not ref["shard"]
    assert sh["streamed"] == ref["streamed"]
    np.testing.assert_array_equal(sh["S"], ref["S"])
    assert sh["n_selects"] == ref["n_selects"]
    np.testing.assert_allclose(sh["L"], ref["L"], rtol=1e-5, atol=1e-5)
    byte_tol = 1e-4 if label == "act_l1" else 0.0
    np.testing.assert_allclose(sh["meter"]["bandwidth_bytes"],
                               ref["meter"]["bandwidth_bytes"], rtol=byte_tol)
    if not byte_tol:
        assert sh["meter"]["bandwidth_bytes"] == \
            ref["meter"]["bandwidth_bytes"]
    for f in ("client_flops", "server_flops", "host_device_bytes"):
        assert sh["meter"][f] == ref["meter"][f], f
    tol = 1e-3 if label == "joint" else 1e-4
    for key in ("server_params", "client_params", "masks", "m_opt"):
        assert _max_diff(sh["state"][key], ref["state"][key]) < tol, key
    assert len(sh["history"]) == len(ref["history"])
    for h_s, h_r in zip(sh["history"], ref["history"]):
        assert (h_s["round"], h_s["phase"]) == (h_r["round"], h_r["phase"])
        assert h_s["bandwidth_gb"] == pytest.approx(
            h_r["bandwidth_gb"], rel=byte_tol or 1e-12)
        if h_r["ce"] is not None:
            assert h_s["ce"] == pytest.approx(h_r["ce"], rel=1e-5, abs=1e-5)
        assert h_s["client_loss"] == pytest.approx(h_r["client_loss"],
                                                   rel=1e-5, abs=1e-5)


@pytest.mark.parametrize("label", SHARDED)
def test_interconnect_is_the_formula_and_the_bytes_moved(ranks, unsharded,
                                                         label):
    sh, ref = ranks[0][label], unsharded(label)
    assert ref["meter"]["interconnect_bytes"] == 0.0
    if sh["streamed"]:
        # the reference's streamed sharded run bills no interconnect; the
        # port's spill exchange is its own cost, counted apart
        assert sh["meter"]["interconnect_bytes"] == 0.0
        assert sh["iteration_bytes"] == 0.0
        assert sh["moved"]["stream_spill"] > 0
        kw = {**job.DEFAULTS, **job.CASES[label][0]}
        assert sh["collectives"]["stream_spill"] == \
            kw["rounds"] - int(round(kw["kappa"] * kw["rounds"]))
        return
    n_iter = _n_global_iterations(label)
    assert sh["meter"]["interconnect_bytes"] > 0.0
    assert sh["meter"]["interconnect_bytes"] == \
        sh["iteration_bytes"] * n_iter
    assert sh["moved"]["iteration"] == sh["meter"]["interconnect_bytes"]
    assert sh["collectives"]["iteration"] == n_iter


@pytest.mark.parametrize("label", SHARDED)
def test_ranks_end_equal(ranks, label):
    """The replicated global step leaves the server bit-equal on both
    ranks, and both report the same meters, selections and state."""
    a, b = ranks[0][label], ranks[1][label]
    for x, y in zip(tree_leaves(a["state"]), tree_leaves(b["state"])):
        assert np.array_equal(x, y)
    np.testing.assert_array_equal(a["S"], b["S"])
    assert a["meter"] == b["meter"]
    assert a["accuracy"] == b["accuracy"]


@pytest.mark.parametrize("label", ["round", "stream_host"])
def test_sharded_eval_matches(ranks, unsharded, label):
    assert ranks[0][label]["accuracy"] == pytest.approx(
        unsharded(label)["accuracy"], abs=1e-3)


@pytest.mark.parametrize("label", ["round", "joint", "stream_disk_epoch"])
def test_sharded_client_state_is_the_whole_cohort(ranks, unsharded, label):
    """``client_state()`` of a sharded trainer gathers the (C, ...)
    trees, as an unsharded trainer reports them."""
    sh, ref = ranks[0][label]["client_state"], unsharded(label)[
        "client_state"]
    shapes = [np.shape(x) for x in tree_leaves(sh)]
    assert shapes == [np.shape(x) for x in tree_leaves(ref)]
    assert all(s[0] == job.N_CLIENTS for s in shapes)
    assert _max_diff(sh, ref) < (1e-3 if label == "joint" else 1e-4)


def test_sharded_selection_property(ranks):
    """The sharded selection (local advantage -> one all-gather ->
    replicated top-k) equals ``ucb_select`` on the whole state, on fixed
    draws with ties across the rank boundary."""
    for r in ranks:
        assert len(r["selection"]) == 8
        for sharded, whole in r["selection"]:
            np.testing.assert_array_equal(sharded, whole)


def test_non_divisible_cohort_falls_back(ranks, unsharded):
    """5 clients on 2 ranks: warn, run unsharded (the same run on each
    rank), bill no interconnect."""
    sh, ref = ranks[0]["non_divisible"], unsharded("non_divisible")
    assert not sh["shard"]
    assert any("divisible" in w for w in sh["warnings"])
    assert sh["meter"]["interconnect_bytes"] == 0.0
    assert sh["history"][-1]["bandwidth_gb"] > 0
    np.testing.assert_array_equal(sh["S"], ref["S"])
    assert _max_diff(sh["state"], ref["state"]) == 0.0


def test_world_of_one_is_noop():
    """shard_clients on a mesh of one rank degrades to the plain path."""
    tr = AdaSplitTrainer(job.cfg(), AdaSplitHParams(
        rounds=1, kappa=0.0, batch_size=8, shard_clients=True),
        job.clients(3), device="cpu", mesh=make_cohort_mesh(1, device="cpu"))
    assert not tr._shard
    hist = tr.train(eval_every=10)
    assert hist[-1]["bandwidth_gb"] > 0
    assert tr.meter.interconnect_bytes == 0.0


def test_shard_without_scan_drivers_falls_back():
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        tr = AdaSplitTrainer(job.cfg(), AdaSplitHParams(
            rounds=1, round_scan=False, shard_clients=True, batch_size=8),
            job.clients(3), device="cpu")
    assert not tr._shard
    assert any("scan drivers" in str(x.message) for x in w)


def test_a_failing_rank_fails_the_job_with_its_traceback():
    with pytest.raises(RuntimeError, match="a rank that fails"):
        run_ranks(job.boom, 2, backend="gloo", timeout=60.0)


def test_a_stalled_job_is_killed_at_its_timeout():
    with pytest.raises(TimeoutError, match="were killed"):
        run_ranks(job.stall, 2, backend="gloo", args=(60.0,), timeout=3.0)
