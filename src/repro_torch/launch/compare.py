"""Tables 1 and 2 of the paper on the port: AdaSplit against the six
baselines, each trained on the same clients, with accuracy, bandwidth,
client and total TFLOPs, wall time and the C3-Score (eq. 9) under the
paper's budgets (the worst consumption across the methods).

    python -m repro_torch.launch.compare [--protocol noniid|cifar]
        [--rounds R] [--clients N] [--per-client n] [--batch B]
        [--device cuda|cpu] [--reduced]

``--protocol noniid`` is Table 1 (Mixed-NonIID; AdaSplit at (kappa, eta,
lambda) = (0.6, 0.6, 1e-3) and (0.75, 0.6, 1e-3)), ``cifar`` Table 2
(Mixed-CIFAR; (0.6, 0.6, 1e-5) and (0.3, 0.6, 1e-5)).  ``--reduced``
trains the reduced LeNet (16x16 inputs, conv channels (4, 8, 8)) on
cropped images, a size for the CPU.  Each client holds N_TEST test
examples; data and every method's initial state come from seed 0.  The
methods run on the card unless ``--device cpu`` is given.  Nothing is
written to disk.
"""
from __future__ import annotations

import argparse
import csv
import dataclasses
import io
import time

from repro_torch.baselines import BASELINES, make_trainer
from repro_torch.configs.base import get_config
from repro_torch.core.adasplit import AdaSplitHParams, AdaSplitTrainer
from repro_torch.core.c3 import c3_score
from repro_torch.data.synthetic import mixed_cifar, mixed_noniid

VARIANTS = {
    "noniid": (("adasplit(k=0.6,e=0.6)", dict(kappa=0.6, eta=0.6, lam=1e-3)),
               ("adasplit(k=0.75,e=0.6)",
                dict(kappa=0.75, eta=0.6, lam=1e-3))),
    "cifar": (("adasplit(k=0.6,e=0.6)", dict(kappa=0.6, eta=0.6, lam=1e-5)),
              ("adasplit(k=0.3,e=0.6)", dict(kappa=0.3, eta=0.6, lam=1e-5))),
}
HEADER = ("method", "accuracy", "bandwidth_gb", "client_tflops",
          "total_tflops", "wall_s", "c3_score")
REDUCED = dict(image_size=16, conv_channels=(4, 8, 8))
N_TEST = 64


def dataset(protocol: str, n_clients: int, n_per_client: int, n_test: int,
            *, image_size: int = 32, seed: int = 0):
    """The protocol's clients, images cropped to ``image_size``."""
    mk = mixed_noniid if protocol == "noniid" else mixed_cifar
    clients = mk(n_clients, n_per_client, n_test, seed=seed)
    for c in clients:
        c.x = c.x[:, :image_size, :image_size]
        c.test_x = c.test_x[:, :image_size, :image_size]
    return clients


def methods(protocol: str):
    """(tag, name, AdaSplit hparams) of every row of the table."""
    return ([(name, name, {}) for name in BASELINES]
            + [(tag, "adasplit", kw) for tag, kw in VARIANTS[protocol]])


def method_steps(name: str, clients, batch: int, rounds: int) -> int:
    """Optimizer steps a run makes: each client's per local epoch (the
    federated baselines, SL-basic), all clients' T = min per round
    (SplitFed), or the protocol iterations (AdaSplit, all clients in
    one)."""
    per = [len(c.x) // batch for c in clients]
    if name == "adasplit":
        return rounds * min(per)
    if name == "splitfed":
        return rounds * min(per) * len(clients)
    return rounds * sum(per)


def build(name: str, cfg, clients, rounds: int, *, device, batch_size=32,
          **ada_kw):
    if name == "adasplit":
        hp = AdaSplitHParams(rounds=rounds, batch_size=batch_size, **ada_kw)
        return AdaSplitTrainer(cfg, hp, clients, device=device)
    return make_trainer(name, cfg, clients, device=device, rounds=rounds,
                        batch_size=batch_size)


def run_method(tag: str, name: str, cfg, clients, rounds: int, *, device,
               batch_size=32, **ada_kw) -> dict:
    """Train one method (evaluated at mid-run and at the end, as the
    reference's comparison does) -> its row's numbers and the trainer."""
    import torch
    tr = build(name, cfg, clients, rounds, device=device,
               batch_size=batch_size, **ada_kw)
    t0 = time.perf_counter()
    tr.train(eval_every=max(rounds // 2, 1))
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    acc = tr.history[-1].get("accuracy") or tr.evaluate()
    return {"method": tag, "name": name, "accuracy": acc,
            "bandwidth_gb": tr.meter.bandwidth_gb,
            "client_tflops": tr.meter.client_tflops,
            "total_tflops": tr.meter.total_tflops, "wall_s": wall,
            "steps": method_steps(name, clients, batch_size, rounds),
            "trainer": tr}


def c3_budgets(results):
    """(B_max, C_max) = worst consumption across methods (paper §5)."""
    bmax = max(r["bandwidth_gb"] for r in results)
    cmax = max(r["client_tflops"] for r in results)
    return max(bmax, 1e-9), max(cmax, 1e-9)


def score(results):
    """Each result's C3-Score under the common budgets, in place."""
    bmax, cmax = c3_budgets(results)
    for r in results:
        r["c3_score"] = c3_score(r["accuracy"], r["bandwidth_gb"],
                                 r["client_tflops"], bandwidth_budget=bmax,
                                 compute_budget=cmax)
    return results


def rows(results):
    return [[r["method"], f"{r['accuracy']:.2f}", f"{r['bandwidth_gb']:.4f}",
             f"{r['client_tflops']:.4f}", f"{r['total_tflops']:.4f}",
             f"{r['wall_s']:.2f}", f"{r['c3_score']:.3f}"] for r in results]


def run_table(protocol: str, cfg, clients, rounds: int, *, device,
              batch_size=32, on_method=None):
    """Every method of the protocol's table, scored.  ``on_method(tag,
    run)``, when given, is called for each method with a zero-argument
    ``run`` that trains it and returns its result (and returns that
    result): a hook to instrument the runs."""
    results = []
    for tag, name, kw in methods(protocol):
        def run(tag=tag, name=name, kw=kw):
            return run_method(tag, name, cfg, clients, rounds, device=device,
                              batch_size=batch_size, **kw)
        results.append(on_method(tag, run) if on_method else run())
    return score(results)


def format_table(results) -> str:
    """The table as CSV (the method tags hold commas, and are quoted)."""
    buf = io.StringIO()
    csv.writer(buf, lineterminator="\n").writerows([HEADER] + rows(results))
    return buf.getvalue().rstrip("\n")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--protocol", choices=sorted(VARIANTS), default="noniid")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--clients", type=int, default=5)
    ap.add_argument("--per-client", type=int, default=128)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true")
    args = ap.parse_args(argv)
    cfg = get_config("lenet-cifar")
    if args.reduced:
        cfg = dataclasses.replace(cfg, **REDUCED)
    clients = dataset(args.protocol, args.clients, args.per_client, N_TEST,
                      image_size=cfg.image_size)
    results = run_table(args.protocol, cfg, clients, args.rounds,
                        device=args.device, batch_size=args.batch)
    table = {"noniid": "table1_mixed_noniid (paper Table 1)",
             "cifar": "table2_mixed_cifar (paper Table 2)"}[args.protocol]
    print(f"### {table}: {args.clients} clients x {args.per_client} "
          f"examples, {args.rounds} rounds, B={args.batch}, "
          f"{'reduced LeNet' if args.reduced else 'lenet-cifar'}, "
          f"device {args.device}")
    print(format_table(results))
    return results


if __name__ == "__main__":
    main()
