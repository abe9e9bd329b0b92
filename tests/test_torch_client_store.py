"""Streamed client-state residency (``streamed=True``) of the port, and
its client stores (``repro_torch.core.client_store``).

1. Each assertion of ``tests/test_client_store.py`` on the port (its two
   sharded tests wait for the cohort-sharding slice): the streamed
   trainer against the port's resident trainer on the eager, round and
   epoch rungs, on the disk store, disk against host bit-identical, the
   per-scalar, act_l1, even, ragged and auto chunk variants, one-row
   chunks, ``host_device_bytes`` equal across rungs, the two fallbacks,
   and the store unit tests on both backends.  Tolerances are the
   reference test's: selections and the protocol meters exact, client
   state within 2e-5 (1e-4 for one-row chunks).  ``host_device_bytes``
   is held exactly: the resident bill plus the store traffic of every
   round (``_stream_store_bytes``).
2. Against the reference: the port's streamed trainer from the
   reference streamed trainer's state, the reference's jitter injected,
   on the round and epoch rungs and on the disk store: selections,
   ``_n_selects``, the bandwidth and FLOP totals and ``host_device_bytes``
   exactly the reference's; CE and ``orch.L`` within 1e-3 relative (the
   tolerance of ``test_torch_round_scan.py``: float32 on both sides in
   other summation orders, drifting over the run).
3. The streamed init equals the resident init bit for bit, chunk by
   chunk in the resident draw order.
4. Split points 1, 2 and 4 (mu 0.2, 0.5, 0.75 of a five-block LeNet):
   streamed against resident.

Reduced LeNet (16x16 inputs, conv channels (4, 8, 8)), 6 clients, B=8,
torch on one thread."""
import dataclasses
import warnings

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
from repro_torch.core.adasplit import AdaSplitHParams, AdaSplitTrainer
from repro_torch.core.client_store import DiskStore, HostStore, make_store
from repro_torch.data.synthetic import ClientData
from repro_torch.weights import tree_leaves, tree_map

SMALL = dict(image_size=16, conv_channels=(4, 8, 8))
# five blocks, so that mu 0.2 / 0.5 / 0.75 split after blocks 1 / 2 / 4
FIVE = dict(image_size=32, conv_channels=(4, 8, 8, 8, 8))
DEFAULTS = dict(rounds=4, kappa=0.5, eta=0.5, batch_size=8, seed=0)
RUNGS = {"eager": dict(round_scan=False), "round_scan": dict(),
         "epoch_scan": dict(epoch_scan=True)}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _clients(size=16, n=6, n_per_client=48):
    ref = mixed_noniid(n_clients=n, n_per_client=n_per_client, n_test=16,
                       seed=0)
    for c in ref:
        c.x, c.test_x = c.x[:, :size, :size], c.test_x[:, :size, :size]
    return ref, [ClientData(c.x, c.y, c.test_x, c.test_y, c.dataset_id)
                 for c in ref]


@pytest.fixture(scope="module")
def clients6():
    return _clients()[1]


def _cfg(shape=SMALL, **kw):
    return dataclasses.replace(tget_config("lenet-cifar"), **shape, **kw)


def _train(clients, cfg=None, **kw):
    tr = AdaSplitTrainer(cfg or _cfg(), AdaSplitHParams(**{**DEFAULTS, **kw}),
                         clients, device="cpu")
    tr.train(eval_every=2)
    return tr


@pytest.fixture(scope="module")
def resident(clients6):
    """Resident runs by their hparams, each made once."""
    runs = {}

    def get(**kw):
        key = tuple(sorted(kw.items()))
        if key not in runs:
            runs[key] = _train(clients6, **kw)
        return runs[key]
    return get


def _store_bill(tr):
    """The store traffic a streamed run added to ``host_device_bytes``."""
    T = min(len(c.x) for c in tr.clients) // tr.hp.batch_size
    n_local = int(round(tr.hp.kappa * tr.hp.rounds))
    return (n_local * tr._stream_store_bytes(T, False)
            + (tr.hp.rounds - n_local) * tr._stream_store_bytes(T, True))


def _assert_streamed_matches(st, ref, *, tol=2e-5):
    assert st._streamed and not ref._streamed
    np.testing.assert_array_equal(st.orch.S, ref.orch.S)
    assert st.orch._n_selects == ref.orch._n_selects
    np.testing.assert_allclose(st.orch.L, ref.orch.L, rtol=1e-5, atol=1e-5)
    assert st.meter.bandwidth_bytes == ref.meter.bandwidth_bytes
    assert st.meter.client_flops == ref.meter.client_flops
    assert st.meter.server_flops == ref.meter.server_flops
    assert st.meter.host_device_bytes > ref.meter.host_device_bytes
    assert st.meter.host_device_bytes == \
        ref.meter.host_device_bytes + _store_bill(st)
    for a, b in zip(tree_leaves(st.client_state()),
                    tree_leaves(ref.client_state())):
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol)
    assert len(st.history) == len(ref.history)
    for h_s, h_r in zip(st.history, ref.history):
        for k in ("round", "phase", "bandwidth_gb", "client_tflops"):
            assert h_s[k] == h_r[k], k
        for k in ("client_loss", "ce"):
            assert (h_s[k] is None) == (h_r[k] is None), k
            if h_r[k] is not None:
                assert h_s[k] == pytest.approx(h_r[k], rel=1e-4), k
        if "accuracy" in h_r:
            assert h_s["accuracy"] == pytest.approx(h_r["accuracy"],
                                                    abs=1e-3)


# ---------------------------------------------------------------------------
# 1. streamed == resident across the rungs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rung", list(RUNGS))
def test_streamed_matches_resident(clients6, resident, rung):
    st = _train(clients6, streamed=True, stream_chunk=4, **RUNGS[rung])
    _assert_streamed_matches(st, resident(**RUNGS[rung]))


def test_diskstore_matches_resident(clients6, resident, tmp_path):
    st = _train(clients6, streamed=True, stream_chunk=4,
                store_backend="disk", store_dir=str(tmp_path / "spill"))
    assert isinstance(st.store, DiskStore)
    assert st.store.directory == str(tmp_path / "spill")
    _assert_streamed_matches(st, resident())


def test_disk_and_host_store_bit_identical(clients6, tmp_path):
    """Backend choice changes WHERE rows live, never their bytes."""
    h = _train(clients6, streamed=True, stream_chunk=4)
    d = _train(clients6, streamed=True, stream_chunk=4, store_backend="disk",
               store_dir=str(tmp_path / "spill"))
    assert isinstance(h.store, HostStore)
    for a, b in zip(tree_leaves(h.client_state()),
                    tree_leaves(d.client_state())):
        np.testing.assert_array_equal(a, b)
    assert h.meter.host_device_bytes == d.meter.host_device_bytes


@pytest.mark.parametrize("kw", [
    dict(mask_mode="per_scalar"),
    dict(act_l1=1e-4),
    dict(stream_chunk=3),      # even split (the default 4 is ragged)
    dict(stream_chunk=0),      # auto chunk
], ids=["per_scalar", "act_l1", "chunk3", "auto_chunk"])
def test_streamed_variants_match(clients6, resident, kw):
    base = {k: v for k, v in kw.items() if not k.startswith("stream")}
    st = _train(clients6, streamed=True, **{"stream_chunk": 4, **kw})
    if kw.get("stream_chunk") == 0:
        assert st._stream_chunk == min(6, max(32, st.orch.k)) == 6
    _assert_streamed_matches(st, resident(**base))


def test_streamed_chunk1_selections_exact(clients6):
    """One-row chunks: one all-global round, selections exact, state
    within 1e-4."""
    ref = _train(clients6, rounds=1, kappa=0.0)
    st = _train(clients6, rounds=1, kappa=0.0, streamed=True, stream_chunk=1)
    np.testing.assert_array_equal(st.orch.S, ref.orch.S)
    np.testing.assert_allclose(st.orch.L, ref.orch.L, rtol=1e-4, atol=1e-4)
    for a, b in zip(tree_leaves(st.client_state()),
                    tree_leaves(ref.client_state())):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)


def test_streamed_host_device_bytes_rung_invariant(clients6, resident):
    """The store bill is analytic, so all three rungs report the same
    host<->device totals, as the resident rungs do among themselves."""
    res = [resident(**r).meter.host_device_bytes for r in RUNGS.values()]
    assert res[0] == res[1] == res[2]
    stm = [_train(clients6, streamed=True, stream_chunk=4,
                  **r).meter.host_device_bytes for r in RUNGS.values()]
    assert stm[0] == stm[1] == stm[2]
    assert stm[0] > res[0]


# ---------------------------------------------------------------------------
# fallbacks
# ---------------------------------------------------------------------------


def test_streamed_joint_ablation_falls_back(clients6):
    """server_grad_to_client updates client params mid-round, breaking
    the two-pass commutation: the trainer warns and runs resident."""
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        tr = AdaSplitTrainer(
            _cfg(), AdaSplitHParams(rounds=1, kappa=0.0, batch_size=8,
                                    streamed=True,
                                    server_grad_to_client=True),
            clients6[:3], device="cpu")
    assert not tr._streamed
    assert tr.store is None
    assert any("commute" in str(x.message) for x in w)
    hist = tr.train(eval_every=10)
    assert hist[-1]["bandwidth_gb"] > 0


def test_streamed_requires_global_batch(clients6):
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        tr = AdaSplitTrainer(
            _cfg(), AdaSplitHParams(rounds=1, batch_size=8, streamed=True,
                                    global_batch=False),
            clients6[:3], device="cpu")
    assert not tr._streamed
    assert any("global_batch" in str(x.message) for x in w)


def test_hparams_defaults_match_reference():
    port, ref = AdaSplitHParams(), JHParams()
    for f in ("streamed", "store_backend", "store_dir", "stream_chunk",
              "batched_conv", "fused_mask_adam", "fused_server_adam"):
        assert getattr(port, f) == getattr(ref, f), f


# ---------------------------------------------------------------------------
# store unit tests (both backends over the one row-indexed contract)
# ---------------------------------------------------------------------------


def _store_tree(c):
    rng = np.random.default_rng(0)
    return {"w": rng.normal(size=(c, 3, 2)).astype(np.float32),
            "step": np.arange(c, dtype=np.int32)}


@pytest.mark.parametrize("backend", ["host", "disk"])
def test_store_gather_scatter_roundtrip(backend, tmp_path):
    c = 10
    store = make_store(backend, c, directory=str(tmp_path / "s"))
    tree = _store_tree(c)
    store.adopt({"g": tree})
    rows = np.asarray([1, 4, 7])
    got = store.gather(rows, ("g",))["g"]
    assert got["w"].dtype == torch.float32 and got["step"].dtype == torch.int32
    tree_map(lambda a, b: np.testing.assert_array_equal(a, b[rows]), got,
             tree)
    # scatter modified rows back, re-gather sees them
    new = tree_map(lambda l: l[rows] * 2, tree)
    store.scatter(rows, {"g": new})
    again = store.gather(rows, ("g",))["g"]
    tree_map(lambda a, b: np.testing.assert_array_equal(a, b), again, new)
    # untouched rows intact
    rest = np.asarray([0, 2, 3, 5, 6, 8, 9])
    tree_map(lambda a, b: np.testing.assert_array_equal(a, b[rest]),
             store.gather(rest, ("g",))["g"], tree)
    # byte accounting: row_nbytes * n == nbytes
    assert store.nbytes(("g",)) == store.row_nbytes(("g",)) * c
    assert store.nbytes() == c * (3 * 2 * 4 + 4)


def test_make_store_rejects_unknown_backend():
    with pytest.raises(ValueError, match="unknown client-store"):
        make_store("s3", 4)


def test_diskstore_is_a_valid_checkpoint(tmp_path):
    """flush() leaves a directory checkpoint another process could open:
    the spill doubles as a resumable snapshot."""
    c = 6
    store = DiskStore(c, str(tmp_path / "spill"))
    tree = _store_tree(c)
    store.adopt({"g": tree})
    back, meta = store.reopen("g", tree)
    assert meta["group"] == "g"
    assert meta["n_clients"] == c
    tree_map(lambda a, b: np.testing.assert_array_equal(a, b), back, tree)


def test_hoststore_accepts_tensor_rows():
    """Scatter of tensor rows (on the card: CUDA rows, the stream's D2H
    edge) lands as the store dtype; a part of a group may be written."""
    store = HostStore(4)
    store.alloc("g", {"w": torch.empty((4, 2), device="meta"),
                      "v": np.empty((4,), np.int32)})
    store.scatter(np.asarray([0, 2]), {"g": {"w": torch.ones((2, 2)) * 3,
                                             "v": np.asarray([5, 6])}})
    store.scatter(np.asarray([1]), {"g": {"w": torch.full((1, 2), 2.0,
                                                          dtype=torch.float64)}})
    got = store.gather(np.asarray([0, 1, 2]), ("g",))["g"]
    assert got["w"].dtype == torch.float32
    np.testing.assert_array_equal(got["w"], [[3, 3], [2, 2], [3, 3]])
    np.testing.assert_array_equal(got["v"][[0, 2]], [5, 6])


# ---------------------------------------------------------------------------
# 2. against the reference's streamed trainer
# ---------------------------------------------------------------------------


def _ref_state(ref):
    """Copies: the reference's host store hands out its own arrays."""
    cs = ref.client_state()
    return jax.tree.map(lambda a: np.array(a, copy=True), {
        "client_params": cs["cp"]["c"], "proj_params": cs["cp"]["p"],
        "c_opt": cs["co"], "masks": cs["m"], "m_opt": cs["mo"],
        "server_params": ref.server_params, "s_opt": ref.s_opt,
        "ucb": ref.orch.state})


def _log_ingests(orch):
    log, ingest = [], orch.ingest_round

    def logged(sel_idx, losses, state=None):
        log.extend(zip(np.array(sel_idx), np.array(losses, np.float64)))
        ingest(sel_idx, losses, state=state)
    orch.ingest_round = logged
    return log


@pytest.fixture(scope="module")
def reference_runs():
    """The reference's streamed trainer per rung, each trained once, with
    its initial state and selection log."""
    runs = {}

    def get(rung):
        if rung not in runs:
            kw = dict(DEFAULTS, streamed=True, stream_chunk=4, **RUNGS[rung])
            ref_clients, port_clients = _clients()
            jcfg = dataclasses.replace(jget_config("lenet-cifar"), **SMALL)
            ref = JTrainer(jcfg, JHParams(**kw), ref_clients)
            assert ref._streamed
            state0 = _ref_state(ref)
            log = _log_ingests(ref.orch)
            ref.train(eval_every=2)
            runs[rung] = (kw, ref, state0, log, port_clients)
        return runs[rung]
    return get


@pytest.mark.parametrize("rung,backend", [("round_scan", "host"),
                                          ("round_scan", "disk"),
                                          ("epoch_scan", "host")])
def test_streamed_matches_reference_streamed(reference_runs, rung, backend,
                                             tmp_path):
    kw, ref, state0, ref_log, clients = reference_runs(rung)

    def jitter(counter, n):
        return np.asarray(jax.random.uniform(
            ref.orch.select_key(counter), (n,), jnp.float32, 0.0, 1.0))

    port = AdaSplitTrainer(_cfg(), AdaSplitHParams(
        **kw, store_backend=backend, store_dir=str(tmp_path / "spill")),
        clients, device="cpu", jitter=jitter)
    port.set_state(state0)
    log = _log_ingests(port.orch)
    port.train(eval_every=2)
    assert len(log) == len(ref_log) == 12
    for (s_p, ce_p), (s_r, ce_r) in zip(log, ref_log):
        np.testing.assert_array_equal(s_p, s_r)
        np.testing.assert_allclose(ce_p, ce_r, rtol=1e-3)
    np.testing.assert_array_equal(port.orch.S, ref.orch.S)
    np.testing.assert_allclose(port.orch.L, ref.orch.L, rtol=1e-3)
    assert port.orch._n_selects == ref.orch._n_selects == 12
    for f in ("bandwidth_bytes", "client_flops", "server_flops",
              "host_device_bytes"):
        assert getattr(port.meter, f) == getattr(ref.meter, f), f
    assert port.store.nbytes() == ref.store.nbytes()
    for g in ("cp", "co", "m", "mo"):
        assert port.store.row_nbytes((g,)) == ref.store.row_nbytes((g,))


# ---------------------------------------------------------------------------
# 3. the streamed init, 4. split points
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [dict(stream_chunk=4),
                                dict(stream_chunk=1, mask_mode="per_scalar"),
                                dict(stream_chunk=0)],
                         ids=["chunk4", "chunk1_per_scalar", "auto"])
def test_streamed_init_bit_equal_to_resident(clients6, kw):
    mode = {k: v for k, v in kw.items() if k == "mask_mode"}
    res = AdaSplitTrainer(_cfg(), AdaSplitHParams(**mode), clients6,
                          device="cpu")
    st = AdaSplitTrainer(_cfg(), AdaSplitHParams(streamed=True, **kw),
                         clients6, device="cpu")
    a, b = res.get_state(), st.get_state()
    assert list(a) == list(b)
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("mu,split", [(0.2, 1), (0.5, 2), (0.75, 4)])
def test_streamed_matches_resident_at_split_points(mu, split):
    from repro_torch.models import lenet
    cfg = _cfg(FIVE, mu=mu)
    assert lenet.split_index(cfg) == split
    _, clients = _clients(size=32, n=4, n_per_client=16)
    kw = dict(rounds=2, eta=0.5)
    ref = _train(clients, cfg, **kw)
    st = _train(clients, cfg, streamed=True, stream_chunk=3, **kw)
    _assert_streamed_matches(st, ref)
