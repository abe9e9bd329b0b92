#!/usr/bin/env python3
"""Device time and device ops per call of the LeNet trainer's optimizer
and loss calls on one CUDA card, for the ``repro_torch`` package under
SRC.

    python3 scripts/client_step_ms.py [SRC]

SRC defaults to this checkout's ``src``.  To compare two checkouts, run
it for each in turn in one session on one machine (A, B, B, A).  At the
shapes of ``chip_smoke.py``'s main run (lenet-cifar, C=32 clients, B=32,
projection 64, S=19 selected clients), from one trainer's own state and
random gradients, it times through the public calls:

* ``optim.adam.adam_update`` over the client step's leaves (client
  towers and projection heads, per-client steps);
* ``kernels.masked_adam.fused_adam_update`` over the server leaves (one
  step) and over the selected clients' mask leaves (per-row steps);
* ``kernels.ntxent.ntxent_loss`` forward alone, and forward with the
  backward of its sum.

Each reading is the summed device time of the call's device work
(torch.profiler, ``chip_smoke``'s marker-primed sessions), the device
ops it issued, and the host us per call (``chip_smoke.host_us``); the
last line is one JSON object of them, with the card's name and power
limit.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def profiled(fn, iters):
    """(device ms per call, device ops per call) of ``fn`` over ``iters``
    calls after a warm-up, from a session that recorded a marker."""
    import torch
    import chip_smoke as cs
    fn()
    torch.cuda.synchronize()
    for n_markers in cs.PROFILE_MARKERS:
        with cs.primed_profile(n_markers) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        dev, markers = cs.device_records(prof)
        if markers > 0:
            return (sum(d[1] for d in dev) / 1e3 / iters,
                    sum(d[2] for d in dev) / iters)
    return None, None


def main() -> int:
    src = Path(sys.argv[1]).resolve() if len(sys.argv) > 1 else ROOT / "src"
    sys.path.insert(0, str(src))
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.configs.base import get_config
    from repro_torch.core import masks as masks_mod
    from repro_torch.core.adasplit import AdaSplitTrainer
    from repro_torch.core.orchestrator import n_selected
    from repro_torch.data.synthetic import mixed_noniid
    from repro_torch.kernels import _build
    from repro_torch.kernels.masked_adam import fused_adam_update
    from repro_torch.kernels.ntxent import ntxent_loss
    from repro_torch.optim.adam import adam_update
    from repro_torch.weights import strict_fp32, tree_map

    strict_fp32()
    _build.build_all()
    cfg, hp = get_config("lenet-cifar"), cs.trainer_runs()["main"]
    clients = mixed_noniid(cs.N_CLIENTS, n_per_client=hp.batch_size,
                           n_test=8)
    tr = AdaSplitTrainer(cfg, hp, clients, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    grad = lambda tree: tree_map(lambda t: torch.randn(
        t.shape, device="cuda", generator=gen) * 1e-2, tree)
    cp = {"c": tr.client_params, "p": tr.proj_params}
    c_g, s_g = grad(cp), grad(tr.server_params)
    idx = torch.arange(n_selected(cs.N_CLIENTS, hp.eta), device="cuda")
    m_sel = masks_mod.gather_clients(tr.masks, idx)
    mo_sel = masks_mod.gather_clients(tr.m_opt, idx)
    m_g = grad(m_sel)
    C, B, D = cs.N_CLIENTS, hp.batch_size, hp.proj_dim
    raw = torch.randn((C, B, D), device="cuda", generator=gen)
    y = torch.randint(0, cfg.n_classes, (C, B), device="cuda",
                      generator=gen, dtype=torch.int32)    # as the trainer

    def loss_and_grad():
        qg = raw.detach().requires_grad_(True)
        ntxent_loss(qg, y, hp.tau).sum().backward()

    calls = {
        "client_adam": lambda: adam_update(cp, c_g, tr.c_opt, lr=hp.lr),
        "server_adam": lambda: fused_adam_update(tr.server_params, s_g,
                                                 tr.s_opt, lr=hp.lr),
        "mask_adam": lambda: fused_adam_update(m_sel, m_g, mo_sel,
                                               lr=hp.lr),
        "ntxent_forward": lambda: ntxent_loss(raw, y, hp.tau),
        "ntxent_forward_backward": loss_and_grad}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    out = {"src": str(src), "device": torch.cuda.get_device_name(0),
           "nvidia_smi": smi}
    for name, fn in calls.items():
        ms, ops = profiled(fn, 10)
        out[name] = {"device_ms": ms, "device_ops": ops,
                     "host_us": cs.host_us(fn)}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
