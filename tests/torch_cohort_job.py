"""The ranks' side of ``tests/test_torch_cohort_shard.py``: functions that
``repro_torch.launch.distributed.run_ranks`` starts in spawned processes.
This module imports torch and the port only (no JAX), so a rank starts
quickly.  Every run is the reduced LeNet of the tests (16x16 inputs,
conv channels (4, 8, 8)), torch on one thread."""
from __future__ import annotations

import dataclasses
import time
import warnings

import numpy as np
import torch

SMALL = dict(image_size=16, conv_channels=(4, 8, 8))
DEFAULTS = dict(rounds=3, kappa=0.34, batch_size=8, seed=7)
N_CLIENTS = 4
# the sharded runs by label: (hparams beside DEFAULTS, clients)
CASES = {
    "round": (dict(), N_CLIENTS),
    "epoch_chunk0": (dict(epoch_scan=True), N_CLIENTS),
    "epoch_chunk1": (dict(epoch_scan=True, epoch_chunk_rounds=1),
                     N_CLIENTS),
    "joint": (dict(kappa=0.0, server_grad_to_client=True), N_CLIENTS),
    "per_scalar": (dict(kappa=0.0, mask_mode="per_scalar"), N_CLIENTS),
    "act_l1": (dict(kappa=0.0, act_l1=1e-1, act_threshold=0.5), N_CLIENTS),
    "stream_host": (dict(streamed=True, stream_chunk=1), N_CLIENTS),
    "stream_disk_epoch": (dict(streamed=True, store_backend="disk",
                               epoch_scan=True), N_CLIENTS),
    # 5 clients on 2 ranks: warns, runs unsharded
    "non_divisible": (dict(rounds=2), 5),
}


def clients(n: int = N_CLIENTS):
    from repro_torch.data.synthetic import ClientData, mixed_noniid
    out = []
    for c in mixed_noniid(n_clients=n, n_per_client=32, n_test=16, seed=0):
        out.append(ClientData(c.x[:, :16, :16], c.y, c.test_x[:, :16, :16],
                              c.test_y, c.dataset_id))
    return out


def cfg():
    from repro_torch.configs.base import get_config
    return dataclasses.replace(get_config("lenet-cifar"), **SMALL)


def train(label: str, shard: bool, store_dir=None):
    """One case of ``CASES`` on the CPU -> a dict of numpy results."""
    from repro_torch.core.adasplit import AdaSplitHParams, AdaSplitTrainer
    kw, n = CASES[label]
    kw = {**DEFAULTS, **kw, "shard_clients": shard}
    if kw.get("store_backend") == "disk":
        kw["store_dir"] = store_dir
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        tr = AdaSplitTrainer(cfg(), AdaSplitHParams(**kw), clients(n),
                             device="cpu")
    hist = tr.train(eval_every=10)
    m = tr.meter
    return {"shard": tr._shard, "streamed": tr._streamed,
            "warnings": [str(w.message) for w in caught],
            "S": tr.orch.S, "L": tr.orch.L, "n_selects": tr.orch._n_selects,
            "meter": {f: getattr(m, f) for f in (
                "bandwidth_bytes", "client_flops", "server_flops",
                "interconnect_bytes", "host_device_bytes")},
            "history": hist, "state": tr.get_state(),
            "client_state": tr.client_state(), "accuracy": tr.evaluate(),
            "iteration_bytes": tr._iteration_interconnect_bytes(),
            "moved": dict(tr._xchg.bytes) if tr._xchg else {},
            "collectives": dict(tr._xchg.collectives) if tr._xchg else {}}


def selection_property(n: int = 32, k: int = 19, cases: int = 8):
    """On fixed draws: the sharded selection (this rank's slice of the
    bandit state -> its advantages -> one all-gather -> the replicated
    top-k) against ``ucb_select`` on the whole state, near-tie blocks
    across the rank boundary included.  Returns (sharded, whole) id
    arrays per case."""
    from repro_torch.core.orchestrator import (ucb_advantage, ucb_select,
                                               ucb_select_from_advantage)
    from repro_torch.launch.mesh import make_cohort_mesh
    from repro_torch.sharding.exchange import CohortExchange
    mesh = make_cohort_mesh(device="cpu")
    xchg = CohortExchange(mesh)
    nl = n // mesh.world
    lo = mesh.rank * nl
    rng = np.random.default_rng(0)
    out = []
    for case in range(cases):
        l = rng.normal(50, 40, n).astype(np.float32)
        s = rng.uniform(0.5, 2.0, n).astype(np.float32)
        if case % 2:          # exact ties across the rank boundary
            l[:] = l[0]
            s[:] = 1.0
        jitter = rng.uniform(0, 1, n).astype(np.float32)
        if case == 3:         # ties the jitter cannot break either
            jitter[:] = 0.5
        state = {"l_disc": torch.from_numpy(l), "s_disc": torch.from_numpy(s),
                 "last": torch.from_numpy(l), "prev": torch.from_numpy(l),
                 "t": torch.tensor(2 + case, dtype=torch.int32)}
        mine = {key: v[lo:lo + nl] if v.ndim else v
                for key, v in state.items()}
        adv = xchg.gather_rows(ucb_advantage(mine), "select")
        out.append((ucb_select_from_advantage(adv, k, jitter).numpy(),
                    ucb_select(state, k, jitter).numpy()))
    return out


def job(store_dir: str):
    """Every sharded case on this rank, then the selection property."""
    torch.set_num_threads(1)
    out = {label: train(label, True, f"{store_dir}/{label}")
           for label in CASES}
    out["selection"] = selection_property()
    return out


def boom():
    raise ValueError("a rank that fails")


def stall(seconds: float):
    time.sleep(seconds)
