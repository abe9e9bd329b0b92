"""UCB client-selection orchestrator (AdaSplit §3.2, eq. 6), port of
``repro.core.orchestrator``.

A_i = l_i / s_i + sqrt(2 log T / s_i)
  l_i = sum_t gamma^(T-1-t) * L_i^t     (discounted server losses)
  s_i = sum_t gamma^(T-1-t) * S_i^t     (discounted selection flags)

Unselected clients decay their loss estimate:
  L_i^t = (L_i^{t-1} + L_i^{t-2}) / 2,  with L_i init to 100 at t=0,1.

The functional ``ucb_*`` functions keep the O(N) incremental state as
float32 tensors; :class:`Orchestrator` is the host wrapper of the eager
trainer.  Ties are broken by jitter RELATIVE to the advantage magnitude
(``_JITTER``), drawn from a pluggable source: by default a
``torch.Generator`` seeded from the seed and the select counter.  The
reference draws with ``jax.random``, which torch cannot reproduce, so
parity tests inject the reference's draws through ``jitter``.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

INIT_LOSS = 100.0
# ~2-3 f32 ULPs at advantages of ~1e2: breaks representational ties,
# reorders only sub-ULP-scale advantage gaps
_JITTER = 2e-7


def n_selected(n_clients: int, eta: float) -> int:
    """Clients selected per global iteration: round(eta * N), at least 1."""
    return max(1, int(round(eta * n_clients)))


def ucb_init(n: int, *, gamma: float = 0.87, init_loss: float = INIT_LOSS,
             device="cuda") -> dict:
    """Histories L=[init, init], S=[1, 1] per client (T=2)."""
    g = torch.tensor(gamma, dtype=torch.float32)
    full = lambda v: torch.full((n,), v, dtype=torch.float32)
    state = {"l_disc": full(init_loss) * (1.0 + g),
             "s_disc": full(1.0) * (1.0 + g),
             "last": full(init_loss), "prev": full(init_loss),
             "t": torch.tensor(2, dtype=torch.int32)}
    return {k: v.to(device) for k, v in state.items()}


def ucb_advantage(state: dict) -> torch.Tensor:
    """Eq. 6 advantage per client, (N,) float32."""
    s = state["s_disc"].clamp(min=1e-8)
    t = state["t"].clamp(min=2).to(torch.float32)
    return state["l_disc"] / s + torch.sqrt(2.0 * torch.log(t) / s)


def ucb_select_from_advantage(a, k: int, jitter) -> torch.Tensor:
    """Top-k client ids of a full (N,) advantage vector, sorted
    ascending; ``jitter`` is an (N,) uniform [0, 1) float32 draw (a
    tensor or an array)."""
    scale = _JITTER * (1.0 + a.abs().max())
    if not torch.is_tensor(jitter):
        jitter = torch.from_numpy(np.array(jitter, np.float32))
    jitter = jitter.to(device=a.device, dtype=torch.float32)
    # jittered advantages still tie after f32 rounding; like the
    # reference's top_k, the lower index wins a tie (a stable sort)
    order = torch.sort(a + jitter * scale, descending=True, stable=True)
    return torch.sort(order.indices[:k]).values


def ucb_select(state: dict, k: int, jitter) -> torch.Tensor:
    return ucb_select_from_advantage(ucb_advantage(state), k, jitter)


def ucb_update(state: dict, sel_mask, losses, *, gamma: float) -> dict:
    """Append one iteration: sel_mask (N,) 0/1 flags, losses (N,) read
    only where selected (unselected clients decay)."""
    sel = sel_mask.to(torch.float32)
    decayed = (state["last"] + state["prev"]) / 2.0
    new_l = torch.where(sel > 0, losses.to(torch.float32), decayed)
    return {"l_disc": gamma * state["l_disc"] + new_l,
            "s_disc": gamma * state["s_disc"] + sel,
            "last": new_l, "prev": state["last"],
            "t": state["t"] + 1}


def ucb_new_round(state: dict, *, gamma: float) -> dict:
    """Reset per-round history to L=[last, last], S=[1, 1] (T=2)."""
    last = state["last"]
    return {"l_disc": last * (1.0 + gamma),
            "s_disc": torch.ones_like(state["s_disc"]) * (1.0 + gamma),
            "last": last, "prev": last,
            "t": torch.full_like(state["t"], 2)}


def generator_jitter(seed: int) -> Callable[[int, int], torch.Tensor]:
    """The default jitter source: (counter, n) -> (n,) uniform [0, 1)
    from a CPU ``torch.Generator`` seeded by (seed, counter)."""
    def draw(counter: int, n: int) -> torch.Tensor:
        gen = torch.Generator().manual_seed(
            (int(seed) * 1_000_003 + int(counter)) % (2 ** 63))
        return torch.rand((n,), generator=gen, dtype=torch.float32)
    return draw


class Orchestrator:
    """Host wrapper over the functional UCB math for the eager trainer:
    ``select`` draws the counter-th jitter, ``update`` applies one
    iteration, ``new_round`` resets the round history."""

    def __init__(self, n_clients: int, eta: float, gamma: float = 0.87,
                 init_loss: float = INIT_LOSS, seed: int = 0, *,
                 device="cuda",
                 jitter: Optional[Callable[[int, int], object]] = None):
        self.n = n_clients
        self.k = n_selected(n_clients, eta)
        self.gamma = float(gamma)
        self.device = torch.device(device)
        self.state = ucb_init(n_clients, gamma=self.gamma,
                              init_loss=init_loss, device=self.device)
        self.jitter = jitter if jitter is not None else generator_jitter(seed)
        self._n_selects = 0

    def select(self) -> np.ndarray:
        """Top-eta clients by advantage (ties broken by the jitter)."""
        jit = self.jitter(self._n_selects, self.n)
        self._n_selects += 1
        return ucb_select(self.state, self.k, jit).cpu().numpy()

    def update(self, selected: Sequence[int], losses: Sequence[float]):
        """losses: server loss per *selected* client this iteration."""
        sel_idx = np.asarray(selected, np.int64)
        mask = np.zeros((self.n,), np.float32)
        mask[sel_idx] = 1.0
        dense = np.zeros((self.n,), np.float32)
        dense[sel_idx] = np.asarray(losses, np.float32)
        self.state = ucb_update(self.state,
                                torch.from_numpy(mask).to(self.device),
                                torch.from_numpy(dense).to(self.device),
                                gamma=self.gamma)

    def new_round(self):
        self.state = ucb_new_round(self.state, gamma=self.gamma)
