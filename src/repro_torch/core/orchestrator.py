"""UCB client-selection orchestrator (AdaSplit §3.2, eq. 6), port of
``repro.core.orchestrator``.

A_i = l_i / s_i + sqrt(2 log T / s_i)
  l_i = sum_t gamma^(T-1-t) * L_i^t     (discounted server losses)
  s_i = sum_t gamma^(T-1-t) * S_i^t     (discounted selection flags)

Unselected clients decay their loss estimate:
  L_i^t = (L_i^{t-1} + L_i^{t-2}) / 2,  with L_i init to 100 at t=0,1.

The functional ``ucb_*`` functions keep the O(N) incremental state as
float32 tensors; they run on the device inside the trainer's round and
epoch rungs.  :class:`Orchestrator` is the host wrapper: the eager
trainer's ``select``/``update``, the full L/S histories as (N, T)
arrays, and ``ingest_round``/``ingest_epoch``, which absorb what a rung
computed on the device after its one fetch.  Ties are broken by jitter
RELATIVE to the advantage magnitude (``_JITTER``), drawn from a
pluggable source: by default a ``torch.Generator`` seeded from the seed
and the select counter.  The reference draws with ``jax.random``, which
torch cannot reproduce, so parity tests inject the reference's draws
through ``jitter``.
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


def ucb_update_selected(state: dict, idx, losses, *, n: int,
                        gamma: float) -> dict:
    """:func:`ucb_update` from a (k,) selection and its (k,) losses,
    scattered into the dense (N,) flags and losses on the device, as
    the rungs' device iteration does."""
    zeros = torch.zeros((n,), device=idx.device)
    sel = zeros.index_fill(0, idx, 1.0)
    dense = zeros.index_copy(0, idx, losses.to(torch.float32))
    return ucb_update(state, sel, dense, gamma=gamma)


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
    """Host wrapper over the functional UCB math: ``select`` draws the
    counter-th jitter, ``update`` applies one iteration, ``new_round``
    resets the round history.  ``L``/``S`` mirror the full per-round
    histories as (N, T) float64 arrays (row i is client i); live
    decisions come from the incremental device state, the histories are
    for introspection (``advantage``)."""

    def __init__(self, n_clients: int, eta: float, gamma: float = 0.87,
                 init_loss: float = INIT_LOSS, seed: int = 0, *,
                 device="cuda",
                 jitter: Optional[Callable[[int, int], object]] = None):
        self.n = n_clients
        self.k = n_selected(n_clients, eta)
        self.gamma = float(gamma)
        self.init_loss = float(init_loss)
        self.device = torch.device(device)
        self.state = ucb_init(n_clients, gamma=self.gamma,
                              init_loss=init_loss, device=self.device)
        self.L = np.full((n_clients, 2), init_loss, np.float64)
        self.S = np.ones((n_clients, 2), np.float64)
        self.jitter = jitter if jitter is not None else generator_jitter(seed)
        self._n_selects = 0

    def jitter_schedule(self, counter: int, T: int) -> torch.Tensor:
        """(T, N) float32 CPU draws of iterations ``counter`` ..
        ``counter + T - 1``: row t is what ``select`` draws as its
        ``counter + t``-th selection, so a rung that selects on the
        device from these rows selects as the eager ``select`` does."""
        def row(j):
            if torch.is_tensor(j):
                return j.to("cpu", torch.float32)
            return torch.tensor(np.asarray(j), dtype=torch.float32)
        rows = [row(self.jitter(counter + t, self.n)) for t in range(T)]
        return torch.stack(rows) if rows else torch.zeros((0, self.n))

    def select_on(self, state: dict, counter: int) -> torch.Tensor:
        """The selection on an explicit (device) bandit state with the
        jitter row of select counter ``counter`` (from this
        orchestrator's source, an injected one included), WITHOUT
        advancing ``_n_selects``: the streamed round selects ahead of
        staging the selected rows, and ``ingest_round`` advances the
        counter for the whole round.  On the card the jitter row goes up
        from page-locked memory without blocking."""
        jit = self.jitter_schedule(counter, 1)[0]
        if self.device.type == "cuda":
            jit = jit.pin_memory().to(self.device, non_blocking=True)
        return ucb_select(state, self.k, jit)

    def update_on(self, state: dict, idx, losses) -> dict:
        """:meth:`update` on an explicit (device) state from a (k,)
        selection and its losses, both on the device; the histories are
        replayed later by ``ingest_round``."""
        return ucb_update_selected(state, idx, losses, n=self.n,
                                   gamma=self.gamma)

    def advantage(self) -> np.ndarray:
        """Eq. 6 from the full history (one discount matvec): a
        cross-check of the incremental state, not the decision path."""
        T = self.L.shape[1]
        disc = self.gamma ** (T - 1 - np.arange(T))
        l = self.L @ disc
        s = np.maximum(self.S @ disc, 1e-8)
        return l / s + np.sqrt(2.0 * np.log(max(T, 2)) / s)

    def select(self) -> np.ndarray:
        """Top-eta clients by advantage (ties broken by the jitter)."""
        jit = self.jitter(self._n_selects, self.n)
        self._n_selects += 1
        return ucb_select(self.state, self.k, jit).cpu().numpy()

    def _dense(self, selected, losses):
        """(N,) float32 selection flags and losses from a selection."""
        sel_idx = np.asarray(selected, np.int64)
        mask = np.zeros((self.n,), np.float32)
        mask[sel_idx] = 1.0
        dense = np.zeros((self.n,), np.float32)
        dense[sel_idx] = np.asarray(losses, np.float32)
        return mask, dense

    def _update_state(self, mask, dense):
        self.state = ucb_update(self.state,
                                torch.from_numpy(mask).to(self.device),
                                torch.from_numpy(dense).to(self.device),
                                gamma=self.gamma)

    def update(self, selected: Sequence[int], losses: Sequence[float]):
        """losses: server loss per *selected* client this iteration."""
        mask, dense = self._dense(selected, losses)
        self._update_state(mask, dense)
        self._append_history(mask, dense)

    def _append_history(self, mask, dense):
        decayed = (self.L[:, -1] + self.L[:, -2]) / 2.0
        new_l = np.where(mask > 0, dense, decayed)
        self.L = np.column_stack([self.L, new_l])
        self.S = np.column_stack([self.S, mask.astype(np.float64)])

    def new_round(self):
        self.state = ucb_new_round(self.state, gamma=self.gamma)
        self._reset_round_history()

    def _reset_round_history(self):
        """The host-history half of ``new_round``: L=[last, last],
        S=[1, 1]; the epoch rung resets the device state itself."""
        last = self.L[:, -1]
        self.L = np.column_stack([last, last])
        self.S = np.ones((self.n, 2), np.float64)

    # -- the rungs: whole rounds and epochs computed on the device -----
    def ingest_round(self, sel_idx, losses, state=None):
        """Absorb a round computed on the device.  sel_idx (T, k) client
        ids and losses (T, k) per-selected CE.  ``state`` (the rung's
        final bandit state) is adopted as it is; without it the updates
        are replayed on ``self.state``.  Advances the select counter by
        T, as T ``select`` calls would."""
        sel_idx = np.asarray(sel_idx)
        losses = np.asarray(losses)
        for t in range(sel_idx.shape[0]):
            mask, dense = self._dense(sel_idx[t], losses[t])
            self._append_history(mask, dense)
            if state is None:
                self._update_state(mask, dense)
        if state is not None:
            self.state = state
        self._n_selects += sel_idx.shape[0]

    def ingest_epoch(self, sel_idx, losses, *, state, n_rounds=None):
        """Absorb an epoch of R rounds computed on the device, each opened
        by ``ucb_new_round`` there: R x (``_reset_round_history``;
        ``ingest_round``) with the final ``state`` adopted.  sel_idx and
        losses (R, T, k), or None for a local epoch (pass ``n_rounds``),
        which only resets the histories."""
        if sel_idx is None:
            for _ in range(n_rounds):
                self._reset_round_history()
            self.state = state
            return
        sel_idx = np.asarray(sel_idx)
        losses = np.asarray(losses)
        for r in range(sel_idx.shape[0]):
            self._reset_round_history()
            self.ingest_round(sel_idx[r], losses[r], state=state)
