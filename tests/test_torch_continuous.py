"""Port parity: the continuous-batching engine
(``repro_torch.serve.ContinuousEngine``, ``SlotScheduler``,
``models.decode.merge_slot_cache``, ``core.masks.init_slot_gates`` and
``set_slot_gates``) against the JAX package's, on ``qwen2-0.5b``'s
``reduced()`` config in float32, and the reference test's differentials
(``tests/test_serve_continuous.py``) on the port alone.

As in ``tests/test_torch_serve.py`` the config and params are float32:
with a random model the greedy tokens of two frameworks may part at a
bf16 near-tie, so tokens must be EQUAL in float32.  The reference's
params and masks cross over through numpy; prompts are numpy draws from
a seed.  Counting ``EngineStats`` fields, the admission log and the
completion order must be equal too.  The cache and gate surgery is
bit-equal to the JAX functions on the same numpy inputs."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.configs.base import get_config as jget_config
from repro.core import masks as jmasks
from repro.launch.steps import init_serve_params as jinit_serve_params
from repro.models import decode as jdec
from repro.serve import ContinuousEngine as JContinuousEngine
from repro.serve import Request as JRequest
from repro.serve import SlotScheduler as JSlotScheduler
from repro_torch.configs.base import get_config
from repro_torch.core import masks as tmasks
from repro_torch.models import decode as tdec
from repro_torch.serve import (ContinuousEngine, Request, ServeEngine,
                               SlotScheduler)
from repro_torch.serve.continuous import _bucket
from repro_torch.weights import from_numpy, to_numpy, tree_leaves

N_CLIENTS = 4
# (client, prompt_len, max_new): the reference test's ragged prompts and
# budgets across mixed clients
SPEC = [(0, 8, 4), (1, 5, 2), (2, 11, 6), (0, 3, 1), (1, 8, 3), (3, 6, 5)]
# budget-1 requests free their slot in the admission chain, before any
# decode step, twice in a row on two slots
BUDGET1 = [(0, 5, 1), (1, 9, 1), (2, 4, 3), (3, 7, 1), (0, 6, 2), (1, 3, 1),
           (2, 10, 4), (3, 12, 1)]
# arrivals between step() calls: chunk sizes cycled over the requests
ARRIVALS = [(i % N_CLIENTS, 3 + (5 * i) % 11, 1 + (3 * i) % 6)
            for i in range(12)]
CHUNKS = [2, 1, 3, 0, 4]
COUNTERS = ("requests", "tokens", "completed", "batches", "decode_steps",
            "slot_steps", "slot_capacity", "mixed_batches", "fold_hits",
            "fold_misses", "gate_hits", "gate_misses")


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(jget_config("qwen2-0.5b").reduced(),
                               dtype="float32")
    tcfg = dataclasses.replace(get_config("qwen2-0.5b").reduced(),
                               dtype="float32")
    jp = jinit_serve_params(jcfg, jax.random.PRNGKey(0), dtype="float32")
    rng = np.random.default_rng(9)
    shapes = [m.shape for m in jax.tree.leaves(
        jmasks.init_unit_masks(jcfg, N_CLIENTS))]
    soft = iter([rng.random(s).astype(np.float32) for s in shapes])
    # continuous masks (for the binarized case) and their 0/1 cut
    jsoft = jax.tree.map(lambda _: jnp.asarray(next(soft)),
                         jmasks.init_unit_masks(jcfg, N_CLIENTS))
    jm = jax.tree.map(lambda m: (m > 0.4).astype(jnp.float32), jsoft)
    to_t = lambda t: from_numpy(jax.tree.map(np.asarray, t), "cpu")
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jp, tp=to_t(jp), jm=jm,
                tm=to_t(jm), jsoft=jsoft, tsoft=to_t(jsoft))


def _prompts(spec, vocab, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, pl).astype(np.int32) for _, pl, _ in spec]


def _drive(eng, request_cls, spec, prompts, chunks=None):
    """Serve ``spec`` on ``eng``: all submitted up front and drained by
    ``run_until_idle``, or, with ``chunks``, submitted in chunks (sizes
    cycled) before each ``step()``.  Returns the requests and the
    completion order."""
    reqs = [request_cls(i, c, p, mn)
            for i, ((c, _, mn), p) in enumerate(zip(spec, prompts))]
    if chunks is None:
        for r in reqs:
            eng.submit(r)
        return reqs, [r.req_id for r in eng.run_until_idle()]
    pending, k = list(reqs), 0
    while pending or not eng.sched.idle():
        n = chunks[k % len(chunks)]
        k += 1
        for r in pending[:n]:
            eng.submit(r)
        pending = pending[n:]
        eng.step()
    return reqs, [r.req_id for r in eng._done]


CASES = {
    "spec": dict(spec=SPEC, masks="binary", kw=dict(max_batch=3)),
    "unmasked": dict(spec=SPEC, masks=None, kw=dict(max_batch=2)),
    "binarized": dict(spec=SPEC, masks="soft",
                      kw=dict(max_batch=3, binarize_threshold=0.5)),
    "budget1": dict(spec=BUDGET1, masks="binary", kw=dict(max_batch=2)),
    "arrivals": dict(spec=ARRIVALS, masks="binary", kw=dict(max_batch=3),
                     chunks=CHUNKS),
}


@pytest.mark.parametrize("case", list(CASES))
def test_engine_equals_jax(setup, case):
    """Greedy tokens, counting stats, admission log and completion order
    equal to the JAX ContinuousEngine's."""
    c = CASES[case]
    spec, chunks = c["spec"], c.get("chunks")
    jm = {None: None, "binary": setup["jm"], "soft": setup["jsoft"]}
    tm = {None: None, "binary": setup["tm"], "soft": setup["tsoft"]}
    prompts = _prompts(spec, setup["jcfg"].vocab_size, seed=7)
    kw = dict(c["kw"], cache_len=32)
    jeng = JContinuousEngine(setup["jcfg"], setup["jp"], jm[c["masks"]],
                             **kw)
    teng = ContinuousEngine(setup["tcfg"], setup["tp"], tm[c["masks"]],
                            device="cpu", **kw)
    jreqs, jorder = _drive(jeng, JRequest, spec, prompts, chunks)
    treqs, torder = _drive(teng, Request, spec, prompts, chunks)
    for a, b in zip(jreqs, treqs):
        assert b.output.dtype == np.int32 and b.output.shape == \
            (b.max_new_tokens,)
        np.testing.assert_array_equal(b.output, np.asarray(a.output))
    for name in COUNTERS:
        assert getattr(teng.stats, name) == getattr(jeng.stats, name), name
    assert teng.sched.admission_log == jeng.sched.admission_log
    assert torder == jorder
    assert teng.stats.tokens == teng.stats.completed == \
        sum(mn for _, _, mn in spec)
    assert teng.host_syncs == {"prompt_uploads": len(spec),
                               "row_reads": len(spec)}


# reduced deepseek-moe-16b (dense first layer on the client, a two-layer
# MoE segment on the server), float32: a 30-token prompt is admitted at
# bucket 32 (C = 24) where the short ones get C = 8
MOE_SPEC = [(0, 30, 3), (1, 5, 4), (2, 9, 2), (0, 6, 3), (1, 17, 2),
            (3, 12, 3)]


def test_moe_engine_equals_jax(setup):
    """``ContinuousEngine`` on the MoE stack: the tokens, counting stats,
    admission log and completion order of the reference's engine."""
    jcfg, tcfg = (dataclasses.replace(
        get("deepseek-moe-16b").reduced(), first_k_dense=1, n_layers=3,
        dtype="float32") for get in (jget_config, get_config))
    jp = jinit_serve_params(jcfg, jax.random.PRNGKey(1), dtype="float32")
    rng = np.random.default_rng(12)
    jm = jax.tree.map(lambda m: jnp.asarray(
        (rng.random(m.shape) > 0.4).astype(np.float32)),
        jmasks.init_unit_masks(jcfg, N_CLIENTS))
    to_t = lambda t: from_numpy(jax.tree.map(np.asarray, t), "cpu")
    prompts = _prompts(MOE_SPEC, jcfg.vocab_size, seed=8)
    from repro_torch.models.moe import _capacity
    assert (_capacity(30, tcfg), _capacity(6, tcfg)) == (24, 8)
    kw = dict(max_batch=3, cache_len=48)
    jeng = JContinuousEngine(jcfg, jp, jm, **kw)
    teng = ContinuousEngine(tcfg, to_t(jp), to_t(jm), device="cpu", **kw)
    jreqs, jorder = _drive(jeng, JRequest, MOE_SPEC, prompts)
    treqs, torder = _drive(teng, Request, MOE_SPEC, prompts)
    for a, b in zip(jreqs, treqs):
        np.testing.assert_array_equal(b.output, np.asarray(a.output))
    for name in COUNTERS:
        assert getattr(teng.stats, name) == getattr(jeng.stats, name), name
    assert teng.sched.admission_log == jeng.sched.admission_log
    assert torder == jorder


# ---------------------------------------------------------------------------
# cache and gate surgery, bit-equal to the JAX functions
# ---------------------------------------------------------------------------


def _random_tree(tree, rng):
    return jax.tree.map(lambda l: jnp.asarray(
        rng.standard_normal(l.shape).astype(np.float32)).astype(l.dtype),
        tree)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("slot", [0, 2, 4])
def test_merge_slot_cache_bit_equal(setup, dtype, slot):
    jcfg = dataclasses.replace(setup["jcfg"], dtype=dtype)
    rng = np.random.default_rng(slot)
    batch = _random_tree(jdec.init_cache(jcfg, 5, 24), rng)
    one = _random_tree(jdec.init_cache(jcfg, 1, 24), rng)
    want = jdec.merge_slot_cache(batch, one, jnp.int32(slot))
    tbatch = from_numpy(jax.tree.map(np.asarray, batch), "cpu")
    got = tdec.merge_slot_cache(
        tbatch, from_numpy(jax.tree.map(np.asarray, one), "cpu"), slot)
    assert got is tbatch                          # in place
    w, g = jax.tree.leaves(want), tree_leaves(to_numpy(got))
    assert len(w) == len(g) == 2 * jcfg.n_layers
    for a, b in zip(w, g):
        assert b.shape == a.shape
        np.testing.assert_array_equal(b, np.asarray(a, np.float32))


@pytest.mark.parametrize("n_slots", [1, 3, 8])
def test_init_slot_gates_bit_equal(setup, n_slots):
    want = jmasks.init_slot_gates(setup["jsoft"], n_slots)
    got = tmasks.init_slot_gates(setup["tsoft"], n_slots)
    w, g = jax.tree.leaves(want), tree_leaves(got)
    assert len(w) == len(g) > 0
    for a, b in zip(w, g):
        assert b.dtype == torch.float32 and tuple(b.shape) == a.shape
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.mark.parametrize("slot,client", [(0, 1), (2, 3), (4, 0)])
def test_set_slot_gates_bit_equal(setup, slot, client):
    rng = np.random.default_rng(slot)
    jg = _random_tree(jmasks.init_slot_gates(setup["jsoft"], 5), rng)
    jc = jmasks.gates_for_client(setup["jsoft"], client)
    want = jmasks.set_slot_gates(jg, jnp.int32(slot), jc)
    tg = from_numpy(jax.tree.map(np.asarray, jg), "cpu")
    got = tmasks.set_slot_gates(
        tg, slot, tmasks.gates_for_client(setup["tsoft"], client))
    assert got is tg                              # in place
    for a, b in zip(jax.tree.leaves(want), tree_leaves(got)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


# ---------------------------------------------------------------------------
# the reference test's differentials, on the port alone
# ---------------------------------------------------------------------------


def _serve(eng, spec, prompts):
    reqs, _ = _drive(eng, Request, spec, prompts)
    return [r.output.tolist() for r in reqs]


def _solo(cfg, params, masks, spec, prompts):
    """The oracle of oracles: each request served entirely alone."""
    return [_serve(ServeEngine(cfg, params, masks, max_batch=1,
                               device="cpu"), [s], [p])[0]
            for s, p in zip(spec, prompts)]


def test_continuous_equals_solo_equals_mixed_fifo(setup):
    cfg, tp, tm = setup["tcfg"], setup["tp"], setup["tm"]
    prompts = _prompts(SPEC, cfg.vocab_size)
    solo = _solo(cfg, tp, tm, SPEC, prompts)
    cont = ContinuousEngine(cfg, tp, tm, max_batch=3, cache_len=32,
                            device="cpu")
    fifo = ServeEngine(cfg, tp, tm, max_batch=8, mixed_batches=True,
                       device="cpu")
    assert _serve(cont, SPEC, prompts) == solo
    assert _serve(fifo, SPEC, prompts) == solo
    assert fifo.stats.batches == fifo.stats.mixed_batches == 1
    assert cont.stats.requests == len(SPEC)
    assert 0 < cont.stats.occupancy <= 1.0


def test_fifo_over_decodes_and_continuous_does_not(setup):
    cfg, tp, tm = setup["tcfg"], setup["tp"], setup["tm"]
    spec = [(0, 6, 3), (1, 10, 2), (2, 4, 4), (3, 7, 1), (0, 5, 6),
            (2, 9, 2), (1, 3, 3)]
    prompts = _prompts(spec, cfg.vocab_size, seed=7)
    fifo = ServeEngine(cfg, tp, tm, max_batch=4, mixed_batches=True,
                       device="cpu")
    cont = ContinuousEngine(cfg, tp, tm, max_batch=4, cache_len=32,
                            device="cpu")
    assert _serve(fifo, spec, prompts) == _serve(cont, spec, prompts)
    total = sum(mn for _, _, mn in spec)
    assert fifo.stats.completed == cont.stats.completed == total
    assert cont.stats.tokens == total
    assert fifo.stats.tokens > total


def test_continuous_unmasked_equals_solo(setup):
    cfg, tp = setup["tcfg"], setup["tp"]
    spec = [(0, 5, 3), (1, 5, 3)]
    prompts = _prompts(spec, cfg.vocab_size, seed=5)
    eng = ContinuousEngine(cfg, tp, None, max_batch=2, cache_len=32,
                           device="cpu")
    assert _serve(eng, spec, prompts) == _solo(cfg, tp, None, spec, prompts)


def test_continuous_latency_and_slot_reuse(setup):
    cfg, tp, tm = setup["tcfg"], setup["tp"], setup["tm"]
    spec = [(c % 4, 4 + c, 2 + (c % 3)) for c in range(9)]
    prompts = _prompts(spec, cfg.vocab_size, seed=13)
    eng = ContinuousEngine(cfg, tp, tm, max_batch=3, cache_len=32,
                           device="cpu")
    reqs, order = _drive(eng, Request, spec, prompts)
    assert sorted(order) == list(range(len(spec)))
    for r in reqs:
        assert len(r.output) == r.max_new_tokens
        assert r.t_done >= r.t_admit >= r.t_submit > 0
        assert r.latency_s == r.t_done - r.t_admit
    assert eng.stats.tokens == eng.stats.completed == \
        sum(mn for _, _, mn in spec)
    assert eng.stats.wall_s > 0


def test_engine_gate_lru_under_rotation(setup):
    """A working-set-sized cache: a steady rotation over the clients hits
    after the first pass; an undersized cache is refused."""
    cfg, tp, tm = setup["tcfg"], setup["tp"], setup["tm"]
    eng = ContinuousEngine(cfg, tp, tm, max_batch=2, cache_len=32,
                           gate_cache_size=4, gate_shards=2, device="cpu")
    rng = np.random.default_rng(17)
    for i in range(8):
        eng.submit(Request(i, i % 4, rng.integers(
            0, cfg.vocab_size, 5).astype(np.int32), 2))
    eng.run_until_idle()
    assert eng.stats.gate_misses == 4          # one build per client
    assert eng.stats.gate_hits == 4            # second rotation all hits
    with pytest.raises(ValueError):
        ContinuousEngine(cfg, tp, tm, max_batch=8, gate_cache_size=4,
                         device="cpu")


def test_continuous_validation(setup):
    cfg, tp, tm = setup["tcfg"], setup["tp"], setup["tm"]
    eng = ContinuousEngine(cfg, tp, tm, max_batch=2, cache_len=16,
                           device="cpu")
    with pytest.raises(ValueError):
        eng.submit(Request(0, 0, np.zeros(12, np.int32), 8))   # overflows
    with pytest.raises(ValueError):
        eng.submit(Request(1, 0, np.zeros(4, np.int32), 0))    # no budget
    with pytest.raises(ValueError):
        ContinuousEngine(get_config("lenet-cifar"), tp)        # conv arch
    assert eng.sched.idle() and not eng.step()


def test_continuous_engine_defaults_to_the_card(setup):
    eng = ContinuousEngine(setup["tcfg"], setup["tp"], setup["tm"])
    assert eng.device == torch.device("cuda")


@pytest.mark.parametrize("n,cap,want", [(1, 32, 8), (8, 32, 8), (9, 32, 16),
                                        (17, 32, 32), (33, 32, 32),
                                        (300, 576, 512), (512, 576, 512)])
def test_bucket(n, cap, want):
    assert _bucket(n, cap) == want


# ---------------------------------------------------------------------------
# the host-side scheduler against the reference's
# ---------------------------------------------------------------------------


def _schedule(sched_cls, spec, n_slots, chunks):
    """The engine's loop without a model: submit a chunk, run the
    admission chain, step the active slots.  Returns the admission log
    and every (step, slot, req_id) completion."""
    sched = sched_cls(n_slots)
    reqs = [Request(i, 0, np.zeros(pl, np.int32), mn)
            for i, (pl, mn) in enumerate(spec)]
    done, k, step = [], 0, 0
    while reqs or not sched.idle():
        n = chunks[k % len(chunks)]
        k += 1
        for r in reqs[:n]:
            sched.submit(r)
        reqs = reqs[n:]
        while True:
            admitted = sched.admit()
            completed = sched.pop_completed()
            done += [(step, s, r.req_id) for s, r in completed]
            if not admitted and not completed:
                break
        if sched.active():
            sched.note_step()
            step += 1
            done += [(step, s, r.req_id) for s, r in sched.pop_completed()]
    return sched.admission_log, done


@settings(derandomize=True, database=None, max_examples=60, deadline=None)
@given(spec=st.lists(st.tuples(st.integers(1, 40), st.integers(1, 9)),
                     min_size=1, max_size=24),
       n_slots=st.integers(1, 6),
       chunks=st.lists(st.integers(0, 5), min_size=1, max_size=4).filter(
           any))
def test_scheduler_equals_reference(spec, n_slots, chunks):
    got = _schedule(SlotScheduler, spec, n_slots, chunks)
    assert got == _schedule(JSlotScheduler, spec, n_slots, chunks)
    assert got[0] == list(range(len(spec)))      # strict FIFO admission
    assert sorted(r for _, _, r in got[1]) == list(range(len(spec)))
