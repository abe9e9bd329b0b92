"""Federated baselines: FedAvg / FedProx / Scaffold / FedNova (port of
``repro.baselines.fed``).

One trainer, four aggregation/objective variants, as the paper benchmarks
them: the LeNet backbone, R rounds x 1 local epoch, Adam on-client for
FedAvg/FedProx/FedNova (a fresh Adam state every local epoch; on the
card one launch of the multi-tensor Adam kernel a step), Scaffold with
its canonical SGD + control-variate correction.  Every conv runs through
the panel-GEMM kernel on the card.

Accounting (paper eq. 1-2): the full model travels client->server and
server->client once per round (Scaffold's control variates too, doubling
the payload); ALL training FLOPs are client-side.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.baselines.base import BaselineTrainer
from repro_torch.core.accounting import lenet_flops_per_example
from repro_torch.core.losses import accuracy, cross_entropy
from repro_torch.data.synthetic import batch_iterator
from repro_torch.models import lenet
from repro_torch.optim.adam import adam_init, adam_update
from repro_torch.utils.tree import (tree_add, tree_bytes, tree_grads,
                                    tree_requires_grad, tree_scale, tree_sub,
                                    tree_zeros_like)
from repro_torch.weights import tree_leaves, tree_map


@dataclass
class FedHParams:
    algorithm: str = "fedavg"      # fedavg | fedprox | scaffold | fednova
    rounds: int = 20
    batch_size: int = 32
    lr: float = 1e-3
    prox_mu: float = 0.01          # fedprox proximal coefficient
    scaffold_lr: float = 0.05      # scaffold local SGD lr
    seed: int = 0


class FedTrainer(BaselineTrainer):
    def __init__(self, cfg, hp: FedHParams, clients, *, device="cuda"):
        super().__init__(cfg, hp, clients, device)
        gen = torch.Generator().manual_seed(hp.seed)
        self.global_params = tree_map(lambda t: t.to(self.device),
                                      lenet.init_params(cfg, gen))
        if hp.algorithm == "scaffold":
            self.c_global = tree_zeros_like(self.global_params)
            self.c_local = [tree_zeros_like(self.global_params)
                            for _ in range(self.n)]

    def _state_keys(self):
        if self.hp.algorithm == "scaffold":
            return ("global_params", "c_global", "c_local")
        return ("global_params",)

    # ------------------------------------------------------------------
    def _loss(self, params, x, y, global_params):
        logits, _ = lenet.forward(self.cfg, params, x)
        loss = cross_entropy(logits, y)
        if self.hp.algorithm == "fedprox":
            sq = sum(((a - b) ** 2).sum() for a, b in zip(
                tree_leaves(params), tree_leaves(global_params)))
            loss = loss + 0.5 * self.hp.prox_mu * sq
        return loss

    def _grads(self, params, x, y, global_params):
        p = tree_requires_grad(params)
        with torch.enable_grad():
            return tree_grads(self._loss(p, x, y, global_params), p)

    def _adam_step(self, params, opt, x, y):
        g = self._grads(params, x, y, self.global_params)
        return adam_update(params, g, opt, lr=self.hp.lr)

    def _scaffold_step(self, params, x, y, c_g, c_i):
        """SGD on the corrected gradient g - c_i + c_g; the prox term is
        off (the reference passes ``params`` as the global params)."""
        g = self._grads(params, x, y, params)
        with torch.no_grad():
            g = tree_map(lambda gg, cg, ci: gg - ci + cg, g, c_g, c_i)
            return tree_map(lambda p, gg: p - self.hp.scaffold_lr * gg,
                            params, g)

    def _local_epoch(self, i, params):
        """One local epoch for client i, from a fresh Adam state; returns
        (params, steps).  Reads nothing back from the device."""
        hp = self.hp
        opt = adam_init(params)
        steps = 0
        for x, y in batch_iterator(self.clients[i], hp.batch_size,
                                   self._rng):
            x = torch.from_numpy(x).to(self.device)
            y = torch.from_numpy(y).to(self.device)
            if hp.algorithm == "scaffold":
                params = self._scaffold_step(params, x, y, self.c_global,
                                             self.c_local[i])
            else:
                params, opt = self._adam_step(params, opt, x, y)
            steps += 1
        return params, steps

    def train(self, eval_every: int = 1):
        hp = self.hp
        fl = lenet_flops_per_example(self.cfg, "full")
        model_bytes = tree_bytes(self.global_params)
        for r in range(hp.rounds):
            deltas, taus, new_c_locals = [], [], []
            for i in range(self.n):
                local, steps = self._local_epoch(i, self.global_params)
                deltas.append(tree_sub(local, self.global_params))
                taus.append(max(steps, 1))
                self.meter.add_client_flops(3 * fl * steps * hp.batch_size)
                payload = 2 * model_bytes
                if hp.algorithm == "scaffold":
                    payload *= 2  # control variates travel too
                    # control update (option II of the paper)
                    coef = 1.0 / (max(steps, 1) * hp.scaffold_lr)
                    ci_new = tree_add(
                        tree_sub(self.c_local[i], self.c_global),
                        tree_scale(deltas[-1], -coef), 1.0)
                    new_c_locals.append((i, ci_new))
                self.meter.add_payload(payload)

            upd = tree_zeros_like(self.global_params)
            if hp.algorithm == "fednova":
                # normalized averaging: d_i / tau_i, scaled by mean tau
                tau_eff = float(np.mean(taus))
                for d, t in zip(deltas, taus):
                    upd = tree_add(upd, d, tau_eff / (self.n * t))
            else:
                for d in deltas:
                    upd = tree_add(upd, d, 1.0 / self.n)
            self.global_params = tree_add(self.global_params, upd)

            if hp.algorithm == "scaffold":
                dc = tree_zeros_like(self.c_global)
                for i, ci_new in new_c_locals:
                    dc = tree_add(dc, tree_sub(ci_new, self.c_local[i]),
                                  1.0 / self.n)
                    self.c_local[i] = ci_new
                self.c_global = tree_add(self.c_global, dc)

            rec = {"round": r, **self.meter.summary()}
            if (r + 1) % eval_every == 0 or r == hp.rounds - 1:
                rec["accuracy"] = self.evaluate()
            self.history.append(rec)
        return self.history

    # ------------------------------------------------------------------
    @torch.no_grad()
    def client_accuracies(self) -> np.ndarray:
        """(C,) test accuracy of the global model on each client."""
        accs = []
        for c in self.clients:
            logits, _ = lenet.forward(
                self.cfg, self.global_params,
                torch.from_numpy(c.test_x).to(self.device))
            accs.append(accuracy(logits, torch.from_numpy(c.test_y).to(
                self.device)))
        return torch.stack(accs).cpu().numpy()
