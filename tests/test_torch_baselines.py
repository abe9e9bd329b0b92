"""The port's baselines (``repro_torch.baselines``) and the small modules
they stand on, against the reference package on the CPU.

1. Each of the six baselines against its reference trainer for 2 rounds,
   on the reduced LeNet of ``test_torch_adasplit.py`` (16x16 inputs,
   conv channels (4, 8, 8)), 3 clients, B=8, the port starting from the
   reference's initial state carried across through numpy (JAX PRNG
   inits cannot be reproduced in torch) and drawing the same numpy batch
   stream: state within ``test_torch_adasplit.py``'s tolerance (1e-4
   relative / 1e-5 absolute except at most 0.1% of elements within
   2.5*lr: Adam's early steps are ~lr*sign(g)), meters exact, accuracy
   within one test example per client.
2. The port's copies of ``tests/test_baselines.py``'s assertions, on the
   port's own data and the reduced LeNet (the CPU runs each conv as the
   panel GEMM's plain version, a broadcast product: the published widths
   cost ~0.3 s a step here; ``chip_smoke.py`` runs them on the card).
3. ``utils/tree.py``, ``optim/sgd.py`` (momentum and a mask),
   ``optim/schedules.py`` and ``data/partition.py`` against their
   reference counterparts on the same inputs."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.baselines import make_trainer as jmake_trainer
from repro.configs.base import get_config as jget_config
from repro.data.partition import dirichlet_partition as jdirichlet
from repro.data.synthetic import mixed_noniid as jmixed_noniid
from repro.optim import schedules as jsched
from repro.optim import sgd as jsgd
from repro.utils import tree as jtree
from repro_torch.baselines import BASELINES, make_trainer
from repro_torch.configs.base import get_config as tget_config
from repro_torch.data.partition import dirichlet_partition
from repro_torch.data.synthetic import ClientData, mixed_noniid
from repro_torch.optim import schedules as tsched
from repro_torch.optim import sgd as tsgd
from repro_torch.utils import tree as ttree
from repro_torch.utils.tree import tree_bytes
from repro_torch.weights import from_numpy, to_numpy, tree_leaves

SMALL = dict(image_size=16, conv_channels=(4, 8, 8))
KW = dict(rounds=2, batch_size=8, seed=0)
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


STATE = {"fedavg": ("global_params",), "fedprox": ("global_params",),
         "fednova": ("global_params",),
         "scaffold": ("global_params", "c_global", "c_local"),
         "sl-basic": ("client_params", "c_opts", "server_params", "s_opt"),
         "splitfed": ("client_params", "c_opts", "server_params", "s_opt")}


def _small_clients():
    ref = jmixed_noniid(n_clients=3, n_per_client=16, n_test=16, seed=0)
    for c in ref:
        c.x, c.test_x = c.x[:, :16, :16], c.test_x[:, :16, :16]
    port = [ClientData(c.x, c.y, c.test_x, c.test_y, c.dataset_id)
            for c in ref]
    return ref, port


def _ref_state(tr, name):
    return jax.tree.map(np.asarray, {k: getattr(tr, k) for k in STATE[name]})


def _state_close(got, want, bound):
    off, total = 0, 0
    for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
        b = np.asarray(b)
        if b.dtype.kind != "f":
            np.testing.assert_array_equal(a, b)
            continue
        d = np.abs(a.astype(np.float64) - b)
        assert d.max(initial=0.0) <= bound
        off += int(np.sum(d > 1e-5 + 1e-4 * np.abs(b)))
        total += d.size
    assert off <= 1e-3 * total, (off, total)


def _ref_accuracies(ref, name):
    out = []
    for i, c in enumerate(ref.clients):
        x, y = jnp.asarray(c.test_x), jnp.asarray(c.test_y)
        if name in ("sl-basic", "splitfed"):
            cp = ref.client_params[0 if name == "sl-basic" else i]
            out.append(float(ref._eval(cp, ref.server_params, x, y)))
        else:
            out.append(float(ref._eval(ref.global_params, x, y)))
    return np.asarray(out)


@pytest.mark.parametrize("name", BASELINES)
def test_baseline_matches_reference_two_rounds(name):
    ref_clients, port_clients = _small_clients()
    jcfg = dataclasses.replace(jget_config("lenet-cifar"), **SMALL)
    tcfg = dataclasses.replace(tget_config("lenet-cifar"), **SMALL)
    ref = jmake_trainer(name, jcfg, ref_clients, **KW)
    port = make_trainer(name, tcfg, port_clients, device="cpu", **KW)
    port.set_state(_ref_state(ref, name))
    ref_hist = ref.train(eval_every=1)
    port_hist = port.train(eval_every=1)

    got, want = port.get_state(), _ref_state(ref, name)
    for k in STATE[name]:
        _state_close(got[k], want[k], 2.5 * LR)
    for f in METER:
        assert getattr(port.meter, f) == getattr(ref.meter, f), f
    assert len(port_hist) == len(ref_hist) == 2
    for a, b in zip(port_hist, ref_hist):
        assert {k: v for k, v in a.items() if k != "accuracy"} == \
            {k: v for k, v in b.items() if k != "accuracy"}
    n_test = len(ref_clients[0].test_y)
    assert np.all(np.abs(port.client_accuracies()
                         - _ref_accuracies(ref, name))
                  <= 1.0 / n_test + 1e-6)
    assert abs(port_hist[-1]["accuracy"] - ref_hist[-1]["accuracy"]) \
        <= 100.0 / n_test + 1e-4


def test_make_trainer_refuses_an_unknown_name_and_a_missing_card():
    _, clients = _small_clients()
    cfg = dataclasses.replace(tget_config("lenet-cifar"), **SMALL)
    with pytest.raises(KeyError):
        make_trainer("fedsgd", cfg, clients, device="cpu")
    if not torch.cuda.is_available():
        for name in ("fedavg", "splitfed"):
            with pytest.raises(RuntimeError):
                make_trainer(name, cfg, clients)


def test_state_round_trips_through_numpy():
    _, clients = _small_clients()
    cfg = dataclasses.replace(tget_config("lenet-cifar"), **SMALL)
    for name in ("scaffold", "splitfed"):
        a = make_trainer(name, cfg, clients, device="cpu", rounds=1,
                         batch_size=8)
        a.train()
        b = make_trainer(name, cfg, clients, device="cpu", rounds=1,
                         batch_size=8, seed=5)
        b.set_state(a.get_state())
        for x, y in zip(tree_leaves(a.get_state()),
                        tree_leaves(b.get_state())):
            np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------------------
# 2. the port's copies of tests/test_baselines.py
# ---------------------------------------------------------------------------

CFG = dataclasses.replace(tget_config("lenet-cifar"), **SMALL)


@pytest.fixture(scope="module")
def tiny():
    clients = mixed_noniid(n_clients=3, n_per_client=64, n_test=32, seed=0)
    for c in clients:
        c.x, c.test_x = c.x[:, :16, :16], c.test_x[:, :16, :16]
    return clients


@pytest.mark.parametrize("name", BASELINES)
def test_baseline_trains_and_meters(name, tiny):
    tr = make_trainer(name, CFG, tiny, device="cpu", rounds=2,
                      batch_size=16)
    hist = tr.train()
    assert len(hist) == 2
    assert "accuracy" in hist[-1]
    assert tr.meter.bandwidth_bytes > 0
    assert tr.meter.client_flops > 0
    assert 0.0 <= tr.c3(1.0, 1.0) <= 1.0


def test_fl_bandwidth_is_model_sized(tiny):
    """FL payload ~ 2 x model bytes x clients x rounds (eq. 2)."""
    tr = make_trainer("fedavg", CFG, tiny, device="cpu", rounds=2,
                      batch_size=16)
    tr.train()
    expect = 2 * tree_bytes(tr.global_params) * len(tiny) * 2
    assert abs(tr.meter.bandwidth_bytes - expect) / expect < 1e-6


def test_scaffold_doubles_fl_bandwidth(tiny):
    a = make_trainer("fedavg", CFG, tiny, device="cpu", rounds=1,
                     batch_size=16)
    a.train()
    s = make_trainer("scaffold", CFG, tiny, device="cpu", rounds=1,
                     batch_size=16)
    s.train()
    assert abs(s.meter.bandwidth_bytes - 2 * a.meter.bandwidth_bytes) \
        / a.meter.bandwidth_bytes < 1e-6


def test_sl_client_compute_below_fl(tiny):
    """Split learning's raison d'etre: client FLOPs << FL client FLOPs."""
    fl = make_trainer("fedavg", CFG, tiny, device="cpu", rounds=1,
                      batch_size=16)
    fl.train()
    sl = make_trainer("sl-basic", CFG, tiny, device="cpu", rounds=1,
                      batch_size=16)
    sl.train()
    assert sl.meter.client_flops < 0.5 * fl.meter.client_flops


def test_splitfed_averages_client_models(tiny):
    tr = make_trainer("splitfed", CFG, tiny, device="cpu", rounds=1,
                      batch_size=16)
    tr.train()
    for a, b in zip(tree_leaves(tr.client_params[0]),
                    tree_leaves(tr.client_params[1])):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_compare_cli_scores_every_method_under_common_budgets(capsys):
    """``python -m repro_torch.launch.compare --device cpu --reduced`` at a
    small size: one row per method in the table's order, the budgets the
    worst consumption across methods, each C3 its row's under them."""
    import csv
    from repro_torch.core.c3 import c3_score
    from repro_torch.launch import compare
    results = compare.main(["--device", "cpu", "--reduced", "--clients", "3",
                            "--per-client", "16", "--batch", "8",
                            "--rounds", "2"])
    assert [r["method"] for r in results] == \
        [tag for tag, _, _ in compare.methods("noniid")]
    bmax = max(r["bandwidth_gb"] for r in results)
    cmax = max(r["client_tflops"] for r in results)
    for r in results:
        assert r["c3_score"] == c3_score(
            r["accuracy"], r["bandwidth_gb"], r["client_tflops"],
            bandwidth_budget=bmax, compute_budget=cmax)
        assert 0.0 <= r["c3_score"] <= 1.0 and r["steps"] > 0
    table = list(csv.reader(capsys.readouterr().out.strip().splitlines()[1:]))
    assert tuple(table[0]) == compare.HEADER
    assert [row[0] for row in table[1:]] == [r["method"] for r in results]
    assert all(len(row) == len(compare.HEADER) for row in table)


# ---------------------------------------------------------------------------
# 3. the small modules against the reference
# ---------------------------------------------------------------------------


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.normal(size=(3, 4)).astype(np.float32),
            "b": [rng.normal(size=(5,)).astype(np.float32),
                  rng.normal(size=(2, 2, 2)).astype(np.float32)],
            "n": np.arange(6, dtype=np.int32)}


def _close(got, want, rtol=1e-6):
    got = to_numpy(got) if not isinstance(got, (int, float)) else got
    if isinstance(want, (int, float)):
        assert got == want
        return
    for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
        w = np.asarray(w)
        g = np.asarray(g)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=rtol, atol=1e-7)


def _sgd(mod, fp, momentum, masked):
    params, grads = fp(_tree(1)), fp(_tree(2))
    mask = fp({"a": (np.arange(12).reshape(3, 4) % 2).astype(np.float32),
               "b": [np.ones(5, np.float32),
                     np.zeros((2, 2, 2), np.float32)],
               "n": np.ones(6, np.int32)}) if masked else None
    # the integer leaf plays no part in the update
    drop = lambda t: {k: v for k, v in t.items() if k != "n"}
    params, grads = drop(params), drop(grads)
    mask = drop(mask) if masked else None
    state = mod.sgd_init(params, momentum)
    for _ in range(3):
        params, state = mod.sgd_update(params, grads, state, lr=0.1,
                                       momentum=momentum, mask=mask)
    return params, state


CASES = {
    "tree_add": lambda m, fp: m.tree_add(fp(_tree(1)), fp(_tree(2)), 0.25),
    "tree_sub": lambda m, fp: m.tree_sub(fp(_tree(1)), fp(_tree(2))),
    "tree_scale": lambda m, fp: m.tree_scale(fp(_tree(1)), -3.5),
    "tree_zeros_like": lambda m, fp: m.tree_zeros_like(fp(_tree(1))),
    "tree_l2_norm": lambda m, fp: m.tree_l2_norm(fp(_tree(1))),
    "tree_size": lambda m, fp: m.tree_size(fp(_tree(1))),
    "tree_bytes": lambda m, fp: m.tree_bytes(fp(_tree(1))),
    "tree_cast": lambda m, fp: m.tree_cast(
        fp(_tree(1)), jnp.bfloat16 if m is jtree else torch.bfloat16),
    "sgd": lambda m, fp: _sgd(m, fp, 0.0, False),
    "sgd_momentum_mask": lambda m, fp: _sgd(m, fp, 0.9, True),
}
MODS = {"tree": (jtree, ttree), "sgd": (jsgd, tsgd),
        "sgd_momentum_mask": (jsgd, tsgd)}


@pytest.mark.parametrize("case", list(CASES) + ["constant", "cosine_decay",
                                                "linear_warmup_cosine",
                                                "dirichlet_partition"])
def test_small_module_matches_reference(case):
    if case in CASES:
        jm, tm = MODS.get(case, MODS["tree"])
        want = CASES[case](jm, lambda t: jax.tree.map(jnp.asarray, t))
        got = CASES[case](tm, lambda t: from_numpy(t, "cpu"))
        if case == "tree_cast":
            want = jax.tree.map(lambda x: np.asarray(x.astype(jnp.float32))
                                if x.dtype == jnp.bfloat16 else x, want)
        _close(got, want)
        return
    if case == "dirichlet_partition":
        y = np.random.default_rng(3).integers(0, 10, 400)
        for alpha, n in ((0.5, 5), (0.1, 8), (5.0, 3)):
            got = dirichlet_partition(y, n, alpha=alpha, seed=7)
            want = jdirichlet(y, n, alpha=alpha, seed=7)
            assert len(got) == len(want)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
        return
    args = {"constant": (3e-4,), "cosine_decay": (1e-3, 50, 0.2),
            "linear_warmup_cosine": (1e-3, 10, 60)}[case]
    jf, tf = getattr(jsched, case)(*args), getattr(tsched, case)(*args)
    for step in (0, 1, 5, 10, 11, 37, 50, 59, 60, 80):
        got = tf(step)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(jf(step)), rtol=1e-6)
        np.testing.assert_allclose(
            float(tf(torch.tensor(step, dtype=torch.int32))),
            float(jf(jnp.int32(step))), rtol=1e-6)
