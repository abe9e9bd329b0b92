"""Quickstart of the PyTorch port: train AdaSplit (the paper's protocol)
on the paper's LeNet backbone with the Mixed-NonIID protocol, compare
against FedAvg, and print the C3-Score for both (the torch counterpart
of ``examples/quickstart.py``, same defaults).

  PYTHONPATH=src python examples/torch_quickstart.py [--rounds 8] \
      [--device cuda|cpu]

Runs on the CUDA card by default; ``--device cpu`` runs the kernels'
plain versions on the CPU.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.baselines import make_trainer
from repro_torch.configs.base import get_config
from repro_torch.core.adasplit import AdaSplitHParams, AdaSplitTrainer
from repro_torch.core.c3 import c3_score
from repro_torch.data.synthetic import mixed_noniid


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--clients", type=int, default=5)
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    args = ap.parse_args(argv)

    cfg = get_config("lenet-cifar")
    clients = mixed_noniid(args.clients, n_per_client=300, n_test=100,
                           seed=0)

    print(f"== AdaSplit (kappa=0.45, eta=0.6) — {args.rounds} rounds ==")
    hp = AdaSplitHParams(rounds=args.rounds, kappa=0.45, eta=0.6,
                         lam=1e-3)
    ada = AdaSplitTrainer(cfg, hp, clients, device=args.device)
    hist = ada.train(eval_every=max(args.rounds // 2, 1))
    for h in hist:
        acc = f"{h['accuracy']:.1f}%" if "accuracy" in h else "  -  "
        print(f"  round {h['round']:2d} [{h['phase']:6s}] acc={acc} "
              f"bw={h['bandwidth_gb']:.4f}GB")

    print(f"\n== FedAvg — {args.rounds} rounds ==")
    fed = make_trainer("fedavg", cfg, clients, rounds=args.rounds,
                       device=args.device)
    fed.train(eval_every=args.rounds)

    a_acc = ada.history[-1]["accuracy"]
    f_acc = fed.history[-1]["accuracy"]
    bmax = max(ada.meter.bandwidth_gb, fed.meter.bandwidth_gb)
    cmax = max(ada.meter.client_tflops, fed.meter.client_tflops)
    print(f"\n{'':12s} {'acc':>7s} {'bw GB':>8s} {'cl TFLOP':>9s} {'C3':>6s}")
    rows = {}
    for name, tr, acc in (("adasplit", ada, a_acc), ("fedavg", fed, f_acc)):
        c3 = c3_score(acc, tr.meter.bandwidth_gb, tr.meter.client_tflops,
                      bandwidth_budget=bmax, compute_budget=cmax)
        rows[name] = (acc, tr.meter.bandwidth_gb, tr.meter.client_tflops, c3)
        print(f"{name:12s} {acc:6.1f}% {tr.meter.bandwidth_gb:8.4f} "
              f"{tr.meter.client_tflops:9.4f} {c3:6.3f}")
    return rows


if __name__ == "__main__":
    main()
