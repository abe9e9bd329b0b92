"""Port parity: the AdaSplit LM trainer of ``repro_torch`` (the train half
of ``launch.steps``, ``launch.train``, ``data.tokens``,
``core.losses.chunked_cross_entropy``, the transformer FLOP models of
``core.accounting`` and the training attention) against the JAX package,
on ``qwen2-0.5b``'s ``reduced()`` config (2 layers, d_model 256, 4/2
heads of 64, d_ff 512, vocab 512; one client and one server layer).

The reference's ``build_train_step`` wraps its cohort ``vmap`` in
``spmd_axis_name``, which the installed JAX rejects, so the oracle is
composed here from the reference's own functions under a plain
``jax.vmap`` (``tfm.client_forward``, ``client_proj``,
``ntxent_supervised``, ``chunked_cross_entropy``, ``expand_gates``,
``tfm.server_forward``, ``l1_penalty``, ``adam_update``), mirroring
``repro/launch/steps.py``'s ``micro_loss`` and ``train_step`` line for
line without a mesh.  States start from the reference's
``init_train_state`` (carried over by ``weights.train_state_from_numpy``);
the selection jitter is the reference's keyed draw
(``jax.random.uniform(fold_in(PRNGKey(seed), step), (C,))``).

Tolerances.  float32 (``dtype`` and ``param_dtype`` float32): the same
f32 math in other summation orders; losses to 1e-5 relative, gradients
and Adam moments to 5e-5 of each leaf's largest magnitude.  A first
Adam step moves a weight by lr x g / (|g| + eps), so where |g| is near
eps the two sides may part by up to 2 lr: at most 1e-3 of all elements
may move more than 1e-3 lr apart.  bfloat16 (the default policy; cfg
dtype bf16): torch rounds every bf16 op where XLA rounds at the end of
a fusion, and the NT-Xent gradient of near-parallel pooled projections
amplifies rounding, so the port's bf16 client gradients sit 1.5-2.5x
farther from the f32 gradient than the reference's own bf16 ones (those
are 2-4% off in norm): gradients and first moments to 15% relative in
norm per leaf, second moments to 30%, losses to 1e-3 relative, and at
most 5% of the elements may move more than lr/2 apart (a bf16 weight of
order 0.1 has a step of ~0.5 lr).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.core import masks as jmasks
from repro.core import orchestrator as jorch
from repro.core.accounting import Meter as JMeter
from repro.core.accounting import split_payload_bytes as jsplit_payload
from repro.core.accounting import transformer_flops_per_token as jflops
from repro.core.losses import chunked_cross_entropy as jchunked_ce
from repro.core.losses import l1_penalty as jl1
from repro.core.losses import ntxent_supervised as jntxent
from repro.data import tokens as jtokens
from repro.kernels.client_conv import client_proj as jclient_proj
from repro.launch.steps import LaunchPolicy as JPolicy
from repro.launch.steps import init_train_state as jinit_train_state
from repro.models import attention as jattn
from repro.models import transformer as jtfm
from repro.optim.adam import adam_update as jadam_update
from repro_torch.configs.base import InputShape, get_config, list_archs
from repro_torch.core.accounting import transformer_flops_per_token
from repro_torch.core.losses import chunked_cross_entropy
from repro_torch.data import tokens as ttokens
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import attention as tattn
from repro_torch.weights import (from_numpy, to_numpy, train_state_from_numpy,
                                 tree_leaves)

S = 16
LR = 1e-3
SEED = 0
# (dtype, cohorts C, rows per cohort b, microbatch chunks); b >= 4 a chunk
CASES = [("float32", 2, 4, 1), ("float32", 4, 8, 2),
         ("bfloat16", 4, 4, 1), ("bfloat16", 2, 8, 2)]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The tensors here are small: torch's intra-op threads would only
    contend with each other (and with other processes) on a CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _refuse_flash(*a, **k):
    raise AssertionError("the training path reached flash_attention")


@pytest.fixture
def no_flash(monkeypatch):
    """The training path must never reach the flash wrapper (its CPU
    version is differentiable, so only this shows that the card's path,
    which has no backward, is not taken)."""
    monkeypatch.setattr(tattn, "flash_attention", _refuse_flash)


def _cfgs(dtype):
    return (dataclasses.replace(jget_config("qwen2-0.5b").reduced(),
                                dtype=dtype),
            dataclasses.replace(get_config("qwen2-0.5b").reduced(),
                                dtype=dtype))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------------------
# the mesh-free oracle (repro/launch/steps.py:342-390 under a plain vmap)
# ---------------------------------------------------------------------------


EXTRAS = ("src_embeds", "vision_embeds", "positions")


def oracle_step(cfg, C, B, policy):
    """The reference's train_step without a mesh: returns
    step(state, batch) -> (state, metrics with the grads).  A batch's
    modality inputs (``EXTRAS``) are split and threaded as the
    reference's ``_extras_from_batch`` and ``micro_loss`` thread them."""
    b = B // C
    n_micro = max(1, min(policy.microbatch, b))
    while b % n_micro:
        n_micro -= 1
    mb = b // n_micro

    def cohort_client_loss(cp, tokens_b, seq_class_b, extras_b):
        acts = jtfm.client_forward(cfg, cp["model"], tokens_b, extras_b,
                                   remat=policy.remat)
        pooled = jnp.mean(acts.astype(jnp.float32), axis=1)
        q = jclient_proj(cp["proj"], pooled)
        return jntxent(q, seq_class_b, policy.tau), acts

    vmapped_client = jax.vmap(cohort_client_loss)

    def micro_loss(trainables, mtokens, mlabels, mseq_class, select,
                   extras):
        S = mtokens.shape[1]
        ex_c = None
        if extras is not None:
            ex_c = jax.tree.map(
                lambda e: e.reshape((C, mb) + e.shape[1:]), extras)
        closs, acts = vmapped_client(trainables["client"],
                                     mtokens.reshape(C, mb, S),
                                     mseq_class.reshape(C, mb), ex_c)
        l_client = jnp.mean(closs)
        acts_flat = jax.lax.stop_gradient(acts).reshape(C * mb, S, -1)
        client_ids = jnp.repeat(jnp.arange(C), mb)
        gates = jmasks.expand_gates(trainables["masks"], client_ids)
        hidden, aux = jtfm.server_forward(
            cfg, trainables["server"], acts_flat, mtokens, extras,
            gates=gates, remat=policy.remat, return_hidden=True)
        w = select[client_ids][:, None] * jnp.ones((1, S), jnp.float32)
        ce = jchunked_ce(hidden, trainables["server"]["lm_head"]["table"],
                         mlabels, cfg.vocab_size, chunk=policy.ce_chunk,
                         weights=w)
        l_server = ce + policy.lam * jl1(trainables["masks"]) \
            + cfg.router_aux_coef * aux
        return l_client + l_server, (l_client, ce)

    grad_fn = jax.value_and_grad(micro_loss, has_aux=True)

    def split(x):
        y = x.reshape((C, n_micro, mb) + x.shape[1:])
        return y.swapaxes(0, 1).reshape((n_micro, C * mb) + x.shape[1:])

    def step(state, batch):
        trainables, opt = state["trainables"], state["opt"]
        toks, labs = split(batch["tokens"]), split(batch["labels"])
        scls = split(batch["seq_class"])
        exs = {k: split(batch[k]) for k in EXTRAS if k in batch} or None
        if n_micro == 1:
            (_, (lc, ce)), grads = grad_fn(
                trainables, toks[0], labs[0], scls[0], batch["select"],
                jax.tree.map(lambda e: e[0], exs))
        else:
            def micro(carry, xs):
                g_acc, lc_acc, ce_acc = carry
                *xs, mex = xs
                (_, (lc, ce)), g = grad_fn(trainables, *xs, batch["select"],
                                           mex)
                return (jax.tree.map(jnp.add, g_acc, g), lc_acc + lc,
                        ce_acc + ce), None
            zeros = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32),
                                 trainables)
            (grads, lc, ce), _ = jax.lax.scan(
                micro, (zeros, jnp.zeros(()), jnp.zeros(())),
                (toks, labs, scls, exs))
            grads = jax.tree.map(lambda g: g / n_micro, grads)
            lc, ce = lc / n_micro, ce / n_micro
        new_t, new_opt = jadam_update(trainables, grads, opt, lr=policy.lr)
        return ({"trainables": new_t, "opt": new_opt},
                {"l_client": lc, "ce": ce, "grads": grads})

    return step


def oracle_ucb_step(cfg, C, B, policy, eta, gamma):
    """The reference's build_ucb_train_step around :func:`oracle_step`
    (repro/launch/steps.py:436-455)."""
    fn = oracle_step(cfg, C, B, policy)
    k = max(1, int(round(eta * C)))

    def ucb_step(state, ucb, batch, key, is_global):
        g = is_global.astype(jnp.float32)
        idx = jorch.ucb_select(ucb, k, key)
        sel = jnp.zeros((C,), jnp.float32).at[idx].set(1.0) * g
        state, metrics = fn(state, dict(batch, select=sel))
        new_ucb = jorch.ucb_update(ucb, sel, jnp.full((C,), metrics["ce"],
                                                      jnp.float32),
                                   gamma=gamma)
        ucb = jax.tree.map(lambda a, b: jnp.where(g > 0, a, b), new_ucb, ucb)
        return state, ucb, dict(metrics, select=sel)

    return jax.jit(ucb_step), k


def ref_jitter(counter, n):
    """The reference's selection jitter of step ``counter``."""
    key = jax.random.fold_in(jax.random.PRNGKey(SEED), counter)
    return np.asarray(jax.random.uniform(key, (n,), jnp.float32, 0.0, 1.0))


# ---------------------------------------------------------------------------
# one step against the oracle
# ---------------------------------------------------------------------------


def _batch(C, b, phase):
    rng = np.random.default_rng(3)
    B = C * b
    return {"tokens": rng.integers(0, 512, (B, S)).astype(np.int32),
            "labels": rng.integers(0, 512, (B, S)).astype(np.int32),
            "seq_class": np.repeat(np.arange(C), b).astype(np.int32),
            "select": (np.arange(C) % 2 == 0).astype(np.float32)
            * (phase == "global")}


@pytest.fixture(scope="module")
def oracle_runs():
    """(reference initial state, batch, reference state, metrics), per
    (case, phase), computed once."""
    cache = {}

    def get(case, phase):
        if (case, phase) not in cache:
            dtype, C, b, micro = case
            jcfg, _ = _cfgs(dtype)
            pol = JPolicy(microbatch=micro, remat=False, param_dtype=dtype)
            state = jinit_train_state(jcfg, C, pol, jax.random.PRNGKey(SEED))
            batch = _batch(C, b, phase)
            fn = oracle_step(jcfg, C, C * b, pol)
            new, m = jax.jit(fn)(state, batch)
            cache[(case, phase)] = (_np(state), batch, _np(new), _np(m))
        return cache[(case, phase)]
    return get


def _port_step(case, state_np, batch, remat, monkeypatch):
    """The port's train step from the reference's state; returns (new
    state as numpy, metrics, grads as numpy)."""
    dtype, C, b, micro = case
    _, tcfg = _cfgs(dtype)
    pol = tsteps.LaunchPolicy(microbatch=micro, remat=remat,
                              param_dtype=dtype)
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


def _close_tree(got, want, dtype, what, rel_norm=0.15):
    for i, (g, w) in enumerate(zip(tree_leaves(got), jax.tree.leaves(want))):
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape, (what, i)
        if not np.any(w):
            assert not np.any(g), f"{what} leaf {i}: reference all zero"
            continue
        if dtype == "float32":
            err = np.abs(g - w).max() / np.abs(w).max()
            assert err <= 5e-5, f"{what} leaf {i} {w.shape}: {err:.3g}"
        else:
            err = np.linalg.norm(g - w) / np.linalg.norm(w)
            assert err <= rel_norm, f"{what} leaf {i} {w.shape}: {err:.3g}"


def _close_update(got, want, old, dtype):
    """Adam's first-step moves of the two sides, in units of lr."""
    tol, share = (1e-3, 1e-3) if dtype == "float32" else (0.5, 0.05)
    far = total = 0
    for g, w, o in zip(tree_leaves(got), jax.tree.leaves(want),
                       jax.tree.leaves(old)):
        o = np.asarray(o, np.float32)
        d = np.abs((g - o) - (np.asarray(w, np.float32) - o)) / LR
        far += int((d > tol).sum())
        total += d.size
    assert far <= share * total, (far, total)


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no_remat"])
@pytest.mark.parametrize("phase", ["global", "local"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_train_step_matches_reference(case, phase, remat, oracle_runs,
                                      monkeypatch, no_flash):
    dtype = case[0]
    state0, batch, want, wm = oracle_runs(case, phase)
    got, m, grads = _port_step(case, state0, batch, remat, monkeypatch)
    rel = 1e-5 if dtype == "float32" else 1e-3
    np.testing.assert_allclose(float(m["l_client"]), wm["l_client"],
                               rtol=rel)
    assert wm["l_client"] > 0.1          # b >= 4: the client loss is live
    if phase == "local":
        assert float(m["ce"]) == 0.0 == float(wm["ce"])
    else:
        np.testing.assert_allclose(float(m["ce"]), wm["ce"], rtol=rel)
    _close_tree(grads, wm["grads"], dtype, "grad")
    _close_tree(got["opt"]["mu"], want["opt"]["mu"], dtype, "mu")
    _close_tree(got["opt"]["nu"], want["opt"]["nu"], dtype, "nu",
                rel_norm=0.3)
    assert int(got["opt"]["step"]) == int(want["opt"]["step"]) == 1
    _close_update(got["trainables"], want["trainables"],
                  state0["trainables"], dtype)


@pytest.mark.parametrize("case", [CASES[1], CASES[2]],
                         ids=lambda c: "-".join(map(str, c)))
def test_remat_gives_equal_gradients(case, oracle_runs, monkeypatch):
    """torch.utils.checkpoint recomputes each layer: the step's grads and
    new state are bit-equal with it on and off."""
    state0, batch, _, _ = oracle_runs(case, "global")
    on = _port_step(case, state0, batch, True, monkeypatch)
    off = _port_step(case, state0, batch, False, monkeypatch)
    for a, b in zip(tree_leaves([on[0], on[2]]),
                    tree_leaves([off[0], off[2]])):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# free-running steps: selections, UCB state, meter, both drivers
# ---------------------------------------------------------------------------

FREE = dict(C=4, b=4, steps=6, kappa=0.5, eta=0.6, gamma=0.87, log_every=3)


@pytest.fixture(scope="module")
def reference_run():
    """The reference's LMAdaSplitTrainer.run (repro/launch/train.py)
    around the mesh-free step: (initial state, history, final ucb,
    meter summary)."""
    jcfg, _ = _cfgs("float32")
    C, b = FREE["C"], FREE["b"]
    pol = JPolicy(microbatch=1, remat=False, param_dtype="float32")
    state = jinit_train_state(jcfg, C, pol, jax.random.PRNGKey(SEED))
    state0 = _np(state)
    step, k = oracle_ucb_step(jcfg, C, C * b, pol, FREE["eta"],
                              FREE["gamma"])
    ucb = jorch.ucb_init(C, gamma=FREE["gamma"])
    datasets = [jtokens.lm_client_dataset(i, jcfg.vocab_size, S, seed=SEED)
                for i in range(C)]
    it = jtokens.lm_batch_iterator(datasets, b)
    fl_c = jflops(jcfg, "client", S)
    fl_s = jflops(jcfg, "server", S)
    payload = jsplit_payload((b, S, jcfg.d_model), b, dtype_bytes=2)
    meter = JMeter()
    local_steps = int(round(FREE["kappa"] * FREE["steps"]))
    hist = []
    for t in range(FREE["steps"]):
        raw = next(it)
        batch = {"tokens": raw["tokens"], "labels": raw["targets"],
                 "seq_class": raw["seq_labels"],
                 "select": np.ones((C,), np.float32)}
        g = t >= local_steps
        key = jax.random.fold_in(jax.random.PRNGKey(SEED), t)
        state, ucb, m = step(state, ucb, batch, key, jnp.asarray(g))
        meter.add_client_flops(3 * fl_c * b * S * C)
        if g:
            for _ in range(k):
                meter.add_payload(payload)
            meter.add_server_flops(3 * fl_s * b * S * k)
        hist.append({"l_client": float(m["l_client"]), "ce": float(m["ce"]),
                     "selected": [int(i) for i in np.flatnonzero(
                         np.asarray(m["select"]))],
                     "phase": "global" if g else "local"})
    return state0, hist, _np(ucb), meter.summary()


def _port_trainer(state0, epoch_scan):
    _, tcfg = _cfgs("float32")
    C, b = FREE["C"], FREE["b"]
    pol = tsteps.LaunchPolicy(microbatch=1, remat=True,
                              param_dtype="float32")
    like = tsteps.init_train_state(tcfg, C, pol, SEED, device="cpu")
    tr = ttrain.LMAdaSplitTrainer(
        tcfg, InputShape("t", S, C * b, "train"), pol, n_cohorts=C,
        kappa=FREE["kappa"], eta=FREE["eta"], gamma=FREE["gamma"],
        seed=SEED, epoch_scan=epoch_scan, device="cpu", jitter=ref_jitter,
        state=train_state_from_numpy(state0, "cpu", like=like))
    tr.run(FREE["steps"], log_every=FREE["log_every"])
    return tr


@pytest.fixture(scope="module")
def port_runs(reference_run):
    state0 = reference_run[0]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tattn, "flash_attention", _refuse_flash)
        return {False: _port_trainer(state0, False),
                True: _port_trainer(state0, True)}


def test_free_run_matches_reference(reference_run, port_runs):
    _, hist, ucb, summary = reference_run
    tr = port_runs[False]
    assert [h["phase"] for h in tr.history] == [h["phase"] for h in hist] \
        == ["local"] * 3 + ["global"] * 3
    for got, want in zip(tr.history, hist):
        assert got["selected"] == want["selected"]
        np.testing.assert_allclose(got["l_client"], want["l_client"],
                                   rtol=1e-5)
        np.testing.assert_allclose(got["ce"], want["ce"], rtol=1e-5)
    assert [len(h["selected"]) for h in hist] == [0, 0, 0, 2, 2, 2]
    port_ucb = to_numpy(tr.ucb)
    for key in ucb:
        np.testing.assert_allclose(port_ucb[key], ucb[key], rtol=1e-5)
    assert {k: tr.history[-1][k] for k in summary} == summary


def test_windowed_driver_bit_equal_to_per_step(port_runs):
    """The reference's own assertion (tests/test_epoch_scan.py:294-296):
    the window driver's histories equal the per-step driver's; here the
    final states too, bit for bit."""
    step, window = port_runs[False], port_runs[True]
    assert window.history == step.history
    for a, b in zip(tree_leaves([step.state, step.ucb]),
                    tree_leaves([window.state, window.ucb])):
        assert torch.equal(a, b)


def test_windowed_step_equals_its_steps(no_flash):
    """``build_windowed_ucb_step``'s window (one local step, then two
    global) gives what three calls of ``build_ucb_train_step``'s step
    give, bit for bit: states, bandit state and stacked metrics."""
    _, tcfg = _cfgs("float32")
    C, b, W = 2, 4, 3
    shape = InputShape("t", S, C * b, "train")
    pol = tsteps.LaunchPolicy(param_dtype="float32")
    step, k = tsteps.build_ucb_train_step(tcfg, shape, pol, n_cohorts=C)
    window, k_w = tsteps.build_windowed_ucb_step(tcfg, shape, pol,
                                                 n_cohorts=C)
    assert k == k_w == 1
    rng = np.random.default_rng(5)
    batches = {"tokens": rng.integers(0, 512, (W, C * b, S)),
               "labels": rng.integers(0, 512, (W, C * b, S)),
               "seq_class": np.tile(np.repeat(np.arange(C), b), (W, 1))}
    batches = {key: torch.from_numpy(v.astype(np.int32))
               for key, v in batches.items()}
    jitters = torch.from_numpy(rng.random((W, C)).astype(np.float32))
    flags = [False, True, True]
    state = tsteps.init_train_state(tcfg, C, pol, 1, device="cpu")
    ucb = ttrain.ucb_init(C, device="cpu")
    carry = {"state": state, "ucb": ucb}
    got = window(carry, batches, jitters, flags)
    want = []
    for i, g in enumerate(flags):
        state, ucb, m = step(state, ucb,
                             {key: v[i] for key, v in batches.items()},
                             jitters[i], g)
        want.append(m)
    assert [int(x.sum()) for x in got["select"]] == [0, 1, 1]
    for key in got:
        assert torch.equal(got[key], torch.stack([m[key] for m in want]))
    for a, c in zip(tree_leaves([carry["state"], carry["ucb"]]),
                    tree_leaves([state, ucb])):
        assert torch.equal(a, c)


def test_one_fetch_per_window(port_runs):
    n_windows = -(-FREE["steps"] // FREE["log_every"])
    assert port_runs[False].n_fetches == port_runs[True].n_fetches \
        == n_windows


def test_train_cli_runs_on_cpu(tmp_path, capsys):
    path = str(tmp_path / "ckpt")
    ttrain.main(["--reduced", "--device", "cpu", "--steps", "2",
                 "--batch", "4", "--seq", "8", "--log-every", "1",
                 "--checkpoint", path])
    out = capsys.readouterr().out
    assert "done 2 steps" in out and (tmp_path / "ckpt.npz").exists()


def test_vision_shard_is_not_ported(capsys):
    """``--shard`` (the default) is ported now: in a world of one process
    it runs the vision trainer unsharded, as the reference's one-device
    mesh does (the 2-rank form: ``tests/test_torch_examples.py``)."""
    ttrain.main(["--arch", "lenet-cifar", "--device", "cpu", "--clients",
                 "2", "--steps", "1", "--batch", "4"])
    out = capsys.readouterr().out
    assert "done 1 rounds" in out and "sharded=False, world=1" in out


# ---------------------------------------------------------------------------
# the pieces
# ---------------------------------------------------------------------------


def test_tokens_bit_equal_to_reference():
    for cid in (0, 3):
        a = jtokens.lm_client_dataset(cid, 97, 12, seed=5)
        b = ttokens.lm_client_dataset(cid, 97, 12, seed=5)
        for batch in (1, 4):
            x, y = a.sample(batch), b.sample(batch)
            for k in x:
                np.testing.assert_array_equal(x[k], y[k])
                assert x[k].dtype == y[k].dtype
    it_a = jtokens.lm_batch_iterator(
        [jtokens.lm_client_dataset(i, 64, 8) for i in range(3)], 2)
    it_b = ttokens.lm_batch_iterator(
        [ttokens.lm_client_dataset(i, 64, 8) for i in range(3)], 2)
    for _ in range(3):
        x, y = next(it_a), next(it_b)
        assert set(x) == set(y)
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])


@pytest.mark.parametrize("chunk", [24, 8, 16], ids=["one", "three", "halved"])
@pytest.mark.parametrize("weights", ["none", "random", "zero"])
def test_chunked_cross_entropy_matches_reference(chunk, weights):
    """Value and gradient (hidden and table) against the reference: one
    chunk, several, a chunk halved until it divides S (16 -> 8), no
    weights, random ones and all-zero ones; a padded vocabulary (50 of
    64 rows) whose pad rows take no probability."""
    rng = np.random.default_rng(11)
    B, Sl, D, Vp, V = 2, 24, 16, 64, 50
    h = rng.normal(size=(B, Sl, D)).astype(np.float32)
    table = rng.normal(size=(Vp, D)).astype(np.float32) * 0.3
    labels = rng.integers(0, V, (B, Sl)).astype(np.int32)
    w = {"none": None, "random": rng.random((B, Sl)).astype(np.float32),
         "zero": np.zeros((B, Sl), np.float32)}[weights]

    def jloss(h, t):
        return jchunked_ce(h, t, labels, V, chunk=chunk, weights=w)
    want, (gh, gt) = jax.value_and_grad(jloss, argnums=(0, 1))(h, table)
    th = torch.from_numpy(h).requires_grad_(True)
    tt = torch.from_numpy(table).requires_grad_(True)
    got = chunked_cross_entropy(th, tt, torch.from_numpy(labels), V,
                                chunk=chunk, weights=None if w is None
                                else torch.from_numpy(w))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6, atol=0)
    np.testing.assert_allclose(th.grad.numpy(), gh, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(tt.grad.numpy(), gt, rtol=1e-5, atol=1e-7)
    if weights == "zero":
        assert got.item() == 0.0 and not th.grad.any()
    else:
        assert not tt.grad[V:].any()       # the pad rows take no gradient


@pytest.mark.parametrize("arch", ["lenet-cifar"] + list_archs())
def test_transformer_flops_equal_reference(arch):
    jcfg, tcfg = jget_config(arch), get_config(arch)
    for part in ("client", "server", "full"):
        for seq in (0, 128, 4096):
            assert transformer_flops_per_token(tcfg, part, seq) \
                == jflops(jcfg, part, seq)


def test_init_train_state_structure_matches_reference():
    """The port's random train state has the reference's tree: the same
    leaves in the same order with the same shapes and dtypes (bf16 where
    the stacked leaf is large)."""
    jcfg, tcfg = _cfgs("bfloat16")
    pol = JPolicy()
    want = jax.eval_shape(lambda: jinit_train_state(
        jcfg, 4, pol, jax.random.PRNGKey(0)))
    got = tsteps.init_train_state(tcfg, 4, tsteps.LaunchPolicy(), 0,
                                  device="cpu")
    g, w = tree_leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert tuple(a.shape) == tuple(b.shape)
        assert str(a.dtype).split(".")[-1] == str(b.dtype)


# ---------------------------------------------------------------------------
# the repair: training attention, not flash
# ---------------------------------------------------------------------------


def test_training_attention_is_mha_einsum_with_reference_gradients(
        monkeypatch, no_flash):
    """``attn_forward(training=True)`` takes ``mha_einsum`` (flash is
    refused by the fixture) and its gradients with respect to wq, wk and
    wv equal ``jax.grad`` of the reference's forward."""
    jcfg, tcfg = _cfgs("float32")
    p = _np(jattn.attention_init(jax.random.PRNGKey(2), jcfg))
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, S, jcfg.d_model)).astype(np.float32)
    cot = rng.normal(size=(2, S, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S)[None], (2, S)).astype(np.int32)
    calls = []
    einsum = tattn.mha_einsum
    monkeypatch.setattr(tattn, "mha_einsum",
                        lambda *a, **k: calls.append(1) or einsum(*a, **k))

    def jloss(wq, wk, wv):
        q = dict(p, wq=wq, wk=wk, wv=wv)
        out, _ = jattn.attn_forward(q, x, jcfg, positions=pos)
        return jnp.sum(out * cot)
    want = jax.grad(jloss, argnums=(0, 1, 2))(p["wq"], p["wk"], p["wv"])
    tp = from_numpy(p, "cpu")
    for name in ("wq", "wk", "wv"):
        tp[name].requires_grad_(True)
    out, _ = tattn.attn_forward(tp, torch.from_numpy(x), tcfg,
                                positions=torch.from_numpy(pos),
                                training=True)
    (out * torch.from_numpy(cot)).sum().backward()
    assert calls == [1]
    for name, g in zip(("wq", "wk", "wv"), want):
        np.testing.assert_allclose(tp[name].grad.numpy(), g, rtol=1e-4,
                                   atol=1e-5 * np.abs(g).max())


def test_training_attention_above_2048_is_mha_chunked(monkeypatch, no_flash):
    """Above S = 2048 (S % 256 == 0) the training attention is
    ``mha_chunked`` in gcd(S, 1024) blocks, bit-equal to the serving
    path's CPU ``chunked_attention``, and differentiable."""
    calls = []
    chunked = tattn.mha_chunked
    monkeypatch.setattr(tattn, "mha_chunked",
                        lambda *a, **k: calls.append(k) or chunked(*a, **k))
    g = torch.Generator().manual_seed(0)
    q = torch.randn((1, 2304, 2, 16), generator=g).requires_grad_(True)
    k, v = (torch.randn((1, 2304, 1, 16), generator=g) for _ in range(2))
    out = tattn.training_attention(q, k, v, causal=True)
    assert [(c["q_chunk"], c["kv_chunk"]) for c in calls] == [(256, 256)]
    with torch.no_grad():
        assert torch.equal(out, tattn.chunked_attention(q, k, v,
                                                        causal=True))
    out.sum().backward()
    assert torch.isfinite(q.grad).all() and q.grad.abs().sum() > 0
