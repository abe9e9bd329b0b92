"""Split-learning baselines: SL-basic (Gupta & Raskar) and SplitFed (port
of ``repro.baselines.split``).

SL-basic: clients hold the bottom conv blocks, the server the rest.  In
each round clients take turns (round-robin); every iteration sends the
split activations + labels up and the activation gradient down, and the
*client model weights* hop client->client between turns (the classical
protocol's weight relay).  The server trains synchronously with the
active client — the inefficiency AdaSplit removes.

SplitFed: all clients run in parallel against the server each iteration
(one after another here, as in the reference), and a fed server averages
the client models at round end (weights up+down per round, like FedAvg
on the client half).

Both sides take Adam (on the card one launch of the multi-tensor Adam
kernel each); every conv runs through the panel-GEMM kernel on the card.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.baselines.base import BaselineTrainer
from repro_torch.core.accounting import array_bytes, lenet_flops_per_example
from repro_torch.core.losses import accuracy, cross_entropy
from repro_torch.data.synthetic import batch_iterator
from repro_torch.models import lenet
from repro_torch.optim.adam import adam_init, adam_update
from repro_torch.utils.tree import (tree_add, tree_bytes, tree_grads,
                                    tree_requires_grad, tree_zeros_like)
from repro_torch.weights import tree_map


@dataclass
class SplitHParams:
    algorithm: str = "sl-basic"    # sl-basic | splitfed
    rounds: int = 20
    batch_size: int = 32
    lr: float = 1e-3
    seed: int = 0


class SplitTrainer(BaselineTrainer):
    STATE_KEYS = ("client_params", "c_opts", "server_params", "s_opt")

    def __init__(self, cfg, hp: SplitHParams, clients, *, device="cuda"):
        super().__init__(cfg, hp, clients, device)
        gen = torch.Generator().manual_seed(hp.seed)
        dev = lambda tree: tree_map(lambda t: t.to(self.device), tree)
        # SL-basic relays ONE client model between the clients
        n_models = 1 if hp.algorithm == "sl-basic" else self.n
        self.client_params = [dev(lenet.init_client_params(cfg, gen))
                              for _ in range(n_models)]
        self.server_params = dev(lenet.init_server_params(cfg, gen))
        self.c_opts = [adam_init(p) for p in self.client_params]
        self.s_opt = adam_init(self.server_params)
        s = lenet.split_index(cfg)
        hw = cfg.image_size // 2 ** s
        self._acts_spatial = (hw, hw, cfg.conv_channels[s - 1])
        self._fl_c = lenet_flops_per_example(cfg, "client")
        self._fl_s = lenet_flops_per_example(cfg, "server")

    # ------------------------------------------------------------------
    def _step(self, cp, c_opt, x, y):
        """One split-learning iteration: the server computes the loss and
        the gradient flows server->client (the P_si payload); both sides
        take an Adam step.  Updates the server on ``self`` and returns
        the client's (params, Adam state)."""
        cpg, spg = tree_requires_grad((cp, self.server_params))
        with torch.enable_grad():
            acts = lenet.client_forward(self.cfg, cpg, x)
            logits, _ = lenet.server_forward(self.cfg, spg, acts)
            loss = cross_entropy(logits, y)
            gc, gs = tree_grads(loss, (cpg, spg))
        cp, c_opt = adam_update(cp, gc, c_opt, lr=self.hp.lr)
        self.server_params, self.s_opt = adam_update(
            self.server_params, gs, self.s_opt, lr=self.hp.lr)
        return cp, c_opt

    def _bill_step(self, batch: int):
        """One iteration's payload (activations + labels up, the
        activation gradient down) and FLOPs."""
        a = array_bytes((batch,) + self._acts_spatial, 4)
        self.meter.add_payload(2 * a + array_bytes((batch,), 4))
        self.meter.add_client_flops(3 * self._fl_c * batch)
        self.meter.add_server_flops(3 * self._fl_s * batch)

    def _to_device(self, x, y):
        return (torch.from_numpy(x).to(self.device),
                torch.from_numpy(y).to(self.device))

    def _client_turn(self, i):
        """SL-basic: client i trains the relayed client model through
        one epoch of its data against the server, then relays it on."""
        cp, c_opt = self.client_params[0], self.c_opts[0]
        for x, y in batch_iterator(self.clients[i], self.hp.batch_size,
                                   self._rng):
            cp, c_opt = self._step(cp, c_opt, *self._to_device(x, y))
            self._bill_step(x.shape[0])
        self.client_params[0], self.c_opts[0] = cp, c_opt
        # weight relay to the next client
        self.meter.add_payload(tree_bytes(self.client_params[0]))

    def _splitfed_round(self):
        """SplitFed: every client steps against the server each
        iteration, then the client models are averaged (weights up and
        down).  The average is one new tree that every client's entry
        names; the next steps replace entries, never write into them."""
        hp = self.hp
        iters = [list(batch_iterator(self.clients[i], hp.batch_size,
                                     self._rng)) for i in range(self.n)]
        T = min(len(it) for it in iters)
        for t in range(T):
            for i in range(self.n):
                x, y = iters[i][t]
                self.client_params[i], self.c_opts[i] = self._step(
                    self.client_params[i], self.c_opts[i],
                    *self._to_device(x, y))
                self._bill_step(x.shape[0])
        avg = tree_zeros_like(self.client_params[0])
        for p in self.client_params:
            avg = tree_add(avg, p, 1.0 / self.n)
        self.client_params = [avg] * self.n
        self.meter.add_payload(2 * tree_bytes(avg) * self.n)

    def train(self, eval_every: int = 1):
        hp = self.hp
        for r in range(hp.rounds):
            if hp.algorithm == "sl-basic":
                for i in range(self.n):     # round-robin, one relayed model
                    self._client_turn(i)
            else:
                self._splitfed_round()
            rec = {"round": r, **self.meter.summary()}
            if (r + 1) % eval_every == 0 or r == hp.rounds - 1:
                rec["accuracy"] = self.evaluate()
            self.history.append(rec)
        return self.history

    # ------------------------------------------------------------------
    @torch.no_grad()
    def client_accuracies(self) -> np.ndarray:
        """(C,) test accuracy of each client's model (the relayed one in
        SL-basic) under the server."""
        accs = []
        for i, c in enumerate(self.clients):
            cp = self.client_params[0 if self.hp.algorithm == "sl-basic"
                                    else i]
            x, y = self._to_device(c.test_x, c.test_y)
            logits, _ = lenet.server_forward(
                self.cfg, self.server_params,
                lenet.client_forward(self.cfg, cp, x))
            accs.append(accuracy(logits, y))
        return torch.stack(accs).cpu().numpy()
