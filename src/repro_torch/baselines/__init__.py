"""Baselines the paper compares against (§4.2), port of
``repro.baselines``.

Federated: FedAvg, FedProx, Scaffold, FedNova (``baselines.fed``).
Split:     SL-basic (Gupta & Raskar), SplitFed (``baselines.split``).

All use the paper's LeNet backbone and the same synthetic Mixed-CIFAR /
Mixed-NonIID protocols, metered with the same eq. 1-2 accounting, so
Tables 1-2 and the C3-Score comparisons are apples-to-apples.  Each
trainer runs on the card unless the caller passes ``device="cpu"``.
"""
from repro_torch.baselines.fed import FedHParams, FedTrainer
from repro_torch.baselines.split import SplitHParams, SplitTrainer

BASELINES = ("fedavg", "fedprox", "scaffold", "fednova",
             "sl-basic", "splitfed")


def make_trainer(name: str, cfg, clients, *, device="cuda", **kw):
    name = name.lower()
    if name in ("fedavg", "fedprox", "scaffold", "fednova"):
        return FedTrainer(cfg, FedHParams(algorithm=name, **kw), clients,
                          device=device)
    if name in ("sl-basic", "splitfed"):
        return SplitTrainer(cfg, SplitHParams(algorithm=name, **kw), clients,
                            device=device)
    raise KeyError(name)
