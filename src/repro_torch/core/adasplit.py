"""The AdaSplit training protocol (paper §3), classification form — port
of ``repro.core.adasplit`` on one device, in every global-phase form the
reference runs there, on its three dispatch rungs, with the client
state resident or streamed through a host or disk store.

Each iteration:

1. the client step runs all C clients as ONE stacked forward (the
   reference's ``vmap``): LeNet client tower -> projection head ->
   supervised NT-Xent (eq. 5: on the card one forward and one backward
   kernel launch for all C clients) -> plain Adam (on the card one launch
   of the multi-tensor Adam kernel for all leaves).  The loss is the sum
   of the C per-client losses; clients share no parameters, so each
   client's rows of the gradient are its own loss's gradient;
2. in the global phase, UCB selects eta*N clients (eq. 6);
3. one global step over the S selected clients (``global_step``):
   server CE + lambda*L1(masks), the server updated by fused Adam and
   each selected client's masks by per-row fused mask-Adam (eq. 7) —
   each one launch of the multi-tensor ``masked_adam`` kernel on the
   card.  Its forms, as the reference's hparams pick them:

   * ``server_grad_to_client`` (the Table-5 ablation,
     ``global_joint_step``): the selected clients' towers and heads are
     recomputed from their images and trained on NT-Xent + the server
     CE, so the server gradient reaches them; ``flat_joint`` runs the
     server once over the S*B examples, else (and with per-scalar
     masks) stacked over the S clients, the reference's per-client form;
   * ``serialize_server_updates``: the S clients' server steps
     (``server_step``, ``joint_step``) one after another, each updating
     the server before the next, the mask by plain ``adam_update``;
   * ``global_batch=False``: the seed's per-client host loop
     (``_global_iteration_loop``, eager rung only), the oracle of the
     serialized step;
4. the UCB state is updated and ``Meter`` bills bandwidth and compute
   (eq. 1-2), the activation gradient down too under the ablation.

The rungs run the same torch ops in the same order and differ only in
when the host waits for the device:

* eager (``round_scan=False``, or ``global_batch=False``): the host
  selects and bills every global iteration (two device->host copies
  each; the per-client loop reads each selected client's CE);
* round (``round_scan=True``, the default, as in the reference): the
  round's (T, C, B, ...) batches and (T, N) selection jitter are staged
  once from pinned memory, and select / gather / global step / scatter
  / bandit update stay on the device; ONE fetch per global round feeds
  ``Meter.ingest_round`` and ``Orchestrator.ingest_round``, none per
  local round;
* epoch (``epoch_scan=True``): R same-phase rounds (cut at eval
  points) with ``ucb_new_round`` on the device at each boundary, staged
  in chunks of ``epoch_chunk_rounds`` through a two-slot ring (chunk
  k+1 uploaded on a side stream under chunk k's compute); ONE fetch per
  global epoch, none per local one.

Orthogonally to the rungs, the per-client state is resident (the
default: stacked (C, ...) trees on the device) or streamed
(``streamed=True``, the eager, round and epoch rungs alike): the
params, Adam moments and masks live in a ``core/client_store.py`` store
(``store_backend`` "host", pinned tensors, or "disk", memmapped
checkpoint directories) and each round runs as two passes that commute
exactly with the resident interleaving (``_stream_one_round``): every
client's T client steps ``stream_chunk`` rows at a time, then the
global iterations on the spilled activations, each staging only its S
selected clients' mask rows.  The device holds O(chunk) + O(S) client
rows, never O(C); the bandit state and selection stay on it for the
whole population.  The joint ablation and the per-client loop fall back
to resident with a warning, as in the reference.

``evaluate()`` and ``c3()`` (eq. 9) follow the rounds.  Every conv runs
through the panel-GEMM kernel on the card (``batched_conv=False``: the
library conv, the reference path); the server and mask Adam steps take
masked Adam's rounding order (``adam_update``'s under
``fused_server_adam=False`` / ``fused_mask_adam=False``).  The trainer
runs on the device it is given (``"cuda"`` by default) and never moves
work to the CPU on its own.
"""
from __future__ import annotations

import math
import warnings
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import masks as masks_mod
from repro_torch.core.accounting import (Meter, lenet_flops_per_example,
                                         split_payload_bytes)
from repro_torch.core.c3 import c3_score
from repro_torch.core.client_store import make_store
from repro_torch.core.losses import accuracy, l1_penalty, token_nll
from repro_torch.core.orchestrator import (Orchestrator, ucb_new_round,
                                           ucb_select, ucb_update_selected)
from repro_torch.data.synthetic import batch_iterator
from repro_torch.kernels.client_conv import client_proj
from repro_torch.kernels.masked_adam import fused_adam_update
from repro_torch.kernels.ntxent import ntxent_loss
from repro_torch.models import lenet
from repro_torch.optim.adam import adam_init, adam_update
from repro_torch.utils.tree import tree_grads, tree_requires_grad
from repro_torch.weights import (device_of, from_numpy, to_host, to_numpy,
                                 tree_leaves, tree_map, tree_unflatten)


@dataclass
class AdaSplitHParams:
    rounds: int = 20
    kappa: float = 0.6          # local-phase fraction
    eta: float = 0.6            # selected-client fraction
    gamma: float = 0.87         # UCB discount
    lam: float = 1e-5           # mask L1 coefficient
    tau: float = 0.07           # NT-Xent temperature
    lr: float = 1e-3
    batch_size: int = 32
    proj_dim: int = 64
    mask_mode: str = "per_unit"     # "per_unit" | "per_scalar"
    act_l1: float = 0.0             # beta: split-activation sparsification
    act_threshold: float = 1e-3     # payload nnz threshold
    server_grad_to_client: bool = False  # Table-5 ablation (joint step)
    global_batch: bool = True       # batched global phase (False = the
                                    # per-client loop, eager rung)
    serialize_server_updates: bool = False  # the S server steps in turn
    flat_joint: bool = True         # joint step over S*B flattened
                                    # examples (False = per-client form)
    fused_epilogue: bool = False    # bias+ReLU in the panel-GEMM epilogue
    round_scan: bool = True         # a round per dispatch, one fetch per
                                    # global round (False = eager rung)
    epoch_scan: bool = False        # same-phase rounds per dispatch, one
                                    # fetch per global epoch
    epoch_chunk_rounds: int = 0     # rounds per staged chunk (0 = the
                                    # whole epoch at once)
    fused_mask_adam: Optional[bool] = None    # mask / server Adam order:
    fused_server_adam: Optional[bool] = None  # False adam_update's; any
                                    # other value (None, the reference's
                                    # default, or True) masked Adam's
    batched_conv: bool = True       # convs as panel GEMMs (False = the
                                    # library conv, the reference path)
    streamed: bool = False          # client state in a host/disk store:
                                    # the device holds O(chunk) + O(S)
                                    # client rows instead of O(C)
    store_backend: str = "host"     # "host" (pinned tensors) | "disk"
                                    # (checkpoint-directory memmaps)
    store_dir: Optional[str] = None  # DiskStore directory (None = tmp)
    stream_chunk: int = 0           # client rows per streamed chunk
                                    # (0 = auto: max(32, S), at most C)
    seed: int = 0


def _proj_init(gen, in_dim, proj_dim):
    return {"w1": torch.randn((in_dim, 128), generator=gen)
            * (1 / math.sqrt(in_dim)),
            "b1": torch.zeros((128,)),
            "w2": torch.randn((128, proj_dim), generator=gen)
            * (1 / math.sqrt(128))}


def _proj_apply(p, acts):
    """Projection head on split activations (..., B, H', W', C')."""
    h = acts.reshape(tuple(acts.shape[:-3]) + (-1,)).to(torch.float32)
    return client_proj(p, h)


def _stack(trees):
    return tree_map(lambda *ls: torch.stack(ls), *trees)


def _row(tree, k: int):
    """Row ``k`` of every (S, ...) leaf (a view: no copy, no host read)."""
    return tree_map(lambda l: l[k], tree)


def _set_row(tree, k: int, new):
    """A copy of ``tree`` with row ``k`` of every leaf replaced by
    ``new``'s (the reference's ``.at[k].set``)."""
    def put(l, n):
        out = l.clone()
        out[k] = n
        return out
    return tree_map(put, tree, new)


class AdaSplitTrainer:
    def __init__(self, cfg, hp: AdaSplitHParams, clients, *,
                 device="cuda", jitter=None):
        self.cfg, self.hp, self.clients = cfg, hp, clients
        self.n = len(clients)
        self.device = device_of(device)
        self.orch = Orchestrator(self.n, hp.eta, hp.gamma, seed=hp.seed,
                                 device=self.device, jitter=jitter)
        self._streamed = hp.streamed
        if self._streamed and hp.server_grad_to_client:
            warnings.warn(
                "streamed=True is incompatible with the joint "
                "server_grad_to_client step (it updates client params "
                "mid-round, so the client/global passes no longer "
                "commute); falling back to the resident path")
            self._streamed = False
        if self._streamed and not hp.global_batch:
            warnings.warn("streamed=True requires the batched global "
                          "phase (global_batch=True); falling back to "
                          "the resident path")
            self._streamed = False
        self._stream_chunk = min(self.n, hp.stream_chunk
                                 or max(32, self.orch.k))
        self._fwd_kw = dict(fused_epilogue=hp.fused_epilogue,
                            batched_conv=hp.batched_conv)
        # the server's and the masks' Adam order, resolved once: False
        # selects adam_update's, None and True masked Adam's
        self._server_adam_step = adam_update \
            if hp.fused_server_adam is False else fused_adam_update
        self._mask_adam_step = adam_update \
            if hp.fused_mask_adam is False else fused_adam_update
        gen = torch.Generator().manual_seed(hp.seed)
        dev = lambda tree: tree_map(lambda t: t.to(self.device), tree)

        self._acts_spatial = self._acts_shape()
        acts_dim = int(np.prod(self._acts_spatial))
        self.server_params = dev(lenet.init_server_params(cfg, gen))
        self.s_opt = adam_init(self.server_params)
        self.store = None
        if self._streamed:
            self._init_streamed_store(gen, acts_dim)
            self.client_params = self.proj_params = None
            self.masks = self.c_opt = self.m_opt = None
        else:
            self.client_params = dev(_stack(
                [lenet.init_client_params(cfg, gen) for _ in range(self.n)]))
            self.proj_params = dev(_stack(
                [_proj_init(gen, acts_dim, hp.proj_dim)
                 for _ in range(self.n)]))
            self.masks = self._init_masks(self.n, self.device)
            # per-client Adam states carry a per-client step vector
            self.c_opt = self._client_opt(
                {"c": self.client_params, "p": self.proj_params})
            self.m_opt = self._client_opt(self.masks)

        self.meter = Meter()
        self._fl_c = lenet_flops_per_example(cfg, "client")
        self._fl_s = lenet_flops_per_example(cfg, "server")
        self.history: List[Dict[str, Any]] = []
        # rung history records whose client loss is still on the device:
        # (record, summed client loss, T), filled in by the next fetch
        self._pending: List[Tuple[dict, torch.Tensor, int]] = []
        self._rng = np.random.default_rng(hp.seed)

    def _init_masks(self, n: int, device):
        """(n, ...) masks of ones: per-unit, or per-scalar (server
        shaped)."""
        if self.hp.mask_mode == "per_scalar":
            return masks_mod.init_scalar_masks(
                tree_map(lambda p: p.to(device), self.server_params), n)
        return masks_mod.init_lenet_unit_masks(self.cfg, n, device)

    @staticmethod
    def _client_opt(params):
        """``adam_init`` of stacked (n, ...) client leaves, with a step per
        client."""
        opt = adam_init(params)
        lead = tree_leaves(params)[0]
        opt["step"] = torch.zeros(lead.shape[:1], dtype=torch.int32,
                                  device=lead.device)
        return opt

    # ------------------------------------------------------------------
    def _acts_shape(self):
        """(H', W', C') of the split activations: VALID pooling floors
        the spatial size once per client block."""
        s = lenet.split_index(self.cfg)
        hw = self.cfg.image_size
        for _ in range(s):
            hw //= 2
        return (hw, hw, self.cfg.conv_channels[s - 1])

    def _client_groups(self):
        """The per-client state as the store's dict of groups: the
        store's whole population (CPU tensors) when streamed, else the
        resident trees."""
        if self._streamed:
            return self.store.full()
        return {"cp": {"c": self.client_params, "p": self.proj_params},
                "co": self.c_opt, "m": self.masks, "mo": self.m_opt}

    def client_state(self):
        """Numpy copies of the stacked per-client state as the store's
        dict of groups ``{"cp": {"c", "p"}, "co", "m", "mo"}``, whatever
        the residency."""
        return to_numpy(self._client_groups())

    def get_state(self) -> dict:
        """Numpy copies of the training state and the bandit state (the
        client state read from the store when streamed)."""
        g = self._client_groups()
        return to_numpy({
            "client_params": g["cp"]["c"], "proj_params": g["cp"]["p"],
            "c_opt": g["co"], "masks": g["m"], "m_opt": g["mo"],
            "server_params": self.server_params, "s_opt": self.s_opt,
            "ucb": self.orch.state})

    def set_state(self, state: dict):
        """Adopt a numpy state tree (same keys as :meth:`get_state`, e.g.
        the reference trainer's state carried across through numpy),
        written into the store when streamed."""
        groups = {"cp": {"c": state["client_params"],
                         "p": state["proj_params"]},
                  "co": state["c_opt"], "m": state["masks"],
                  "mo": state["m_opt"]}
        if self._streamed:
            self.store.scatter(np.arange(self.n), from_numpy(groups, "cpu"))
        else:
            g = from_numpy(groups, self.device)
            self.client_params, self.proj_params = g["cp"]["c"], g["cp"]["p"]
            self.c_opt, self.masks, self.m_opt = g["co"], g["m"], g["mo"]
        st = from_numpy({k: state[k] for k in ("server_params", "s_opt",
                                               "ucb")}, self.device)
        self.server_params, self.s_opt = st["server_params"], st["s_opt"]
        self.orch.state = st["ucb"]

    # ------------------------------------------------------------------
    # client step: all C clients, one stacked forward
    # ------------------------------------------------------------------
    def _client_part(self, cp_pp, xs):
        """Client tower and projection head, stacked (C, B, ...) or one
        client's (B, ...) -> (split activations, projections)."""
        acts = lenet.client_forward(self.cfg, cp_pp["c"], xs, **self._fwd_kw)
        return acts, _proj_apply(cp_pp["p"], acts)

    def _client_step_rows(self, cp_pp, c_opt, xs, ys):
        """Update the towers + heads of stacked (m, ...) client rows
        ``cp_pp`` (Adam state ``c_opt``, a step per row), each on its own
        batch; returns (new rows, new Adam state, the (m, B, H', W', C')
        split activations, the (m,) losses)."""
        hp = self.hp
        p = tree_requires_grad(cp_pp)
        with torch.enable_grad():
            acts, q = self._client_part(p, xs)
            loss = ntxent_loss(q, ys, hp.tau)                     # (m,)
            if hp.act_l1:
                loss = loss + hp.act_l1 * acts.abs().sum(
                    dim=tuple(range(1, acts.ndim))) / acts.shape[1]
            g = tree_grads(loss.sum(), p)
        new, c_opt = adam_update(cp_pp, g, c_opt, lr=hp.lr)
        return new, c_opt, acts.detach(), loss.detach()

    def _client_step(self, xs, ys):
        """Update every client's tower + head on its own batch (the
        resident trees); returns the (C, B, H', W', C') split activations
        and the (C,) losses."""
        new, self.c_opt, acts, loss = self._client_step_rows(
            {"c": self.client_params, "p": self.proj_params}, self.c_opt,
            xs, ys)
        self.client_params, self.proj_params = new["c"], new["p"]
        return acts, loss

    # ------------------------------------------------------------------
    # global step: S selected clients in one batched server step
    # ------------------------------------------------------------------
    def sparsify(self, acts_sel):
        """(possibly thresholded acts, per-client nnz fractions (S,))."""
        hp = self.hp
        if not hp.act_l1:
            return acts_sel, torch.ones((acts_sel.shape[0],),
                                        device=acts_sel.device)
        nz = acts_sel.abs() > hp.act_threshold
        fracs = nz.to(torch.float32).mean(dim=tuple(range(1, acts_sel.ndim)))
        return torch.where(nz, acts_sel, torch.zeros(
            (), device=acts_sel.device)), fracs

    @staticmethod
    def seg_ces(logits, y_flat, S):
        """Per-client mean CE from (S*B,) flattened logits."""
        return token_nll(logits, y_flat).reshape(S, -1).mean(dim=1)

    def _server_ces(self, sp, msel, acts, ys, *, flat: bool):
        """Per-client server CE: (S,) from stacked (S, B, ...) split
        activations, or one client's scalar from (B, ...).

        ``per_scalar``: per-client effective weights (a forward stacked
        over the S clients).  ``per_unit``: with ``flat``, one (S*B)-
        example forward with per-example gates gathered by client id;
        else a forward stacked over the clients, each gated by its own
        (S, U) mask rows (or one client's (U,) ones)."""
        hp, cfg, kw = self.hp, self.cfg, self._fwd_kw
        if hp.mask_mode == "per_scalar" or not flat:
            if hp.mask_mode == "per_scalar":
                logits, _ = lenet.server_forward(
                    cfg, masks_mod.apply_scalar_masks(sp, msel), acts, **kw)
            else:
                logits, _ = lenet.server_forward(cfg, sp, acts, gates=msel,
                                                 **kw)
            return token_nll(logits, ys).mean(dim=-1)
        S, B = acts.shape[:2]
        seg_ids = torch.arange(S, device=acts.device).repeat_interleave(B)
        gates = tree_map(lambda l: l[seg_ids], msel)
        logits, _ = lenet.server_forward(
            cfg, sp, acts.reshape((S * B,) + acts.shape[2:]), gates=gates,
            **kw)
        return self.seg_ces(logits, ys.reshape(-1), S)

    def _server_adam(self, g_sp):
        """The server's Adam step (one kernel launch on the card), on
        ``self``: masked Adam's rounding order, or ``adam_update``'s
        under ``fused_server_adam=False``."""
        with torch.no_grad():
            self.server_params, self.s_opt = self._server_adam_step(
                self.server_params, g_sp, self.s_opt, lr=self.hp.lr)

    def _mask_adam(self, masks_sel, g_m, m_opt_sel):
        """The selected clients' mask-Adam step, a step per row (one
        kernel launch on the card): masked Adam's rounding order, or
        ``adam_update``'s under ``fused_mask_adam=False``."""
        with torch.no_grad():
            return self._mask_adam_step(masks_sel, g_m, m_opt_sel,
                                        lr=self.hp.lr)

    def global_step(self, masks_sel, m_opt_sel, acts_sel, ys_sel):
        """One server step over the selection; updates the server in
        place on ``self`` and returns (masks_sel, m_opt_sel, ces, fracs).

        ``per_unit``: one (S*B)-example forward with per-example gates
        gathered by client id; ``per_scalar``: per-client effective
        weights, run as a stacked forward over the S clients.  Either
        way the loss is the sum of per-client losses, so the mask grads
        are each client's own and the server grad is their sum (mean =
        /S).  ``serialize_server_updates``: ``server_step`` per client,
        in order (the reference's ``lax.scan``)."""
        hp = self.hp
        acts_sel, fracs = self.sparsify(acts_sel)
        S = acts_sel.shape[0]
        if hp.serialize_server_updates:
            out = [self.server_step(_row(masks_sel, k), _row(m_opt_sel, k),
                                    acts_sel[k], ys_sel[k])
                   for k in range(S)]
            masks_sel, m_opt_sel, ces = (_stack(o) for o in zip(*out))
            return masks_sel, m_opt_sel, ces, fracs
        sp = tree_requires_grad(self.server_params)
        msel = tree_requires_grad(masks_sel)
        with torch.enable_grad():
            ces = self._server_ces(sp, msel, acts_sel, ys_sel, flat=True)
            total = ces.sum() + hp.lam * l1_penalty(msel) * S
            g_sp, g_m = tree_grads(total, (sp, msel))
        self._server_adam(tree_map(lambda t: t / S, g_sp))
        masks_sel, m_opt_sel = self._mask_adam(masks_sel, g_m, m_opt_sel)
        return masks_sel, m_opt_sel, ces.detach(), fracs

    def server_step(self, mask_i, m_opt_i, acts, y):
        """One client's server step (the reference's ``server_step``) on
        its (B, ...) activations: CE + lambda*L1 of its mask; the server
        updated in place on ``self`` by fused Adam, the mask by plain
        ``adam_update``, as the reference does.  Returns (mask_i,
        m_opt_i, ce)."""
        hp = self.hp
        sp, m = tree_requires_grad((self.server_params, mask_i))
        with torch.enable_grad():
            ce = self._server_ces(sp, m, acts, y, flat=False)
            g_sp, g_m = tree_grads(ce + hp.lam * l1_penalty(m), (sp, m))
        self._server_adam(g_sp)
        mask_i, m_opt_i = adam_update(mask_i, g_m, m_opt_i, lr=hp.lr)
        return mask_i, m_opt_i, ce.detach()

    def joint_step(self, cp_pp, c_opt_i, mask_i, m_opt_i, x, y):
        """One client's joint step (the reference's ``joint_step``, the
        Table-5 ablation): its tower and head recomputed from its images
        x (B, ...) and trained on NT-Xent + the server CE, the server on
        the CE (in place on ``self``, fused Adam), its mask on the CE +
        lambda*L1 (``adam_update``).  Returns (cp_pp, c_opt_i, mask_i,
        m_opt_i, ce)."""
        hp = self.hp
        cp, sp, m = tree_requires_grad((cp_pp, self.server_params, mask_i))
        with torch.enable_grad():
            acts, q = self._client_part(cp, x)
            ce = self._server_ces(sp, m, acts, y, flat=False)
            total = ntxent_loss(q, y, hp.tau) + ce \
                + hp.lam * l1_penalty(m)
            g_c, g_sp, g_m = tree_grads(total, (cp, sp, m))
        cp_pp, c_opt_i = adam_update(cp_pp, g_c, c_opt_i, lr=hp.lr)
        self._server_adam(g_sp)
        mask_i, m_opt_i = adam_update(mask_i, g_m, m_opt_i, lr=hp.lr)
        return cp_pp, c_opt_i, mask_i, m_opt_i, ce.detach()

    def global_joint_step(self, cp_sel, c_opt_sel, masks_sel, m_opt_sel,
                          xs_sel, ys_sel, acts_sel):
        """The joint global step over the S selected clients (the
        reference's ``global_joint_step``): the payload nnz fractions come
        from the client step's ``acts_sel``, but the server runs on
        activations recomputed densely from ``xs_sel``.  The loss is the
        sum of the S clients' NT-Xent + CE + lambda*L1*S: each client's
        rows of the gradient are its own, the server's is their sum
        (mean = /S).  The tower is stacked over S, NT-Xent one call over
        S rows; the server runs flat over S*B examples (``flat_joint``,
        per-unit) or stacked over S (the per-client form).  The client
        rows take ``adam_update`` (their per-row steps from ``c_opt_sel``),
        the server fused Adam, the masks fused mask-Adam.
        ``serialize_server_updates``: ``joint_step`` per client, in order.
        Returns (cp_sel, c_opt_sel, masks_sel, m_opt_sel, ces, fracs)."""
        hp = self.hp
        _, fracs = self.sparsify(acts_sel)
        S = xs_sel.shape[0]
        if hp.serialize_server_updates:
            out = [self.joint_step(_row(cp_sel, k), _row(c_opt_sel, k),
                                   _row(masks_sel, k), _row(m_opt_sel, k),
                                   xs_sel[k], ys_sel[k]) for k in range(S)]
            return (*(_stack(o) for o in zip(*out)), fracs)
        cp, sp, msel = tree_requires_grad((cp_sel, self.server_params,
                                           masks_sel))
        with torch.enable_grad():
            acts, q = self._client_part(cp, xs_sel)
            lcs = ntxent_loss(q, ys_sel, hp.tau)                  # (S,)
            ces = self._server_ces(sp, msel, acts, ys_sel,
                                   flat=hp.flat_joint)
            total = lcs.sum() + ces.sum() + hp.lam * l1_penalty(msel) * S
            g_c, g_sp, g_m = tree_grads(total, (cp, sp, msel))
        cp_sel, c_opt_sel = adam_update(cp_sel, g_c, c_opt_sel, lr=hp.lr)
        self._server_adam(tree_map(lambda t: t / S, g_sp))
        masks_sel, m_opt_sel = self._mask_adam(masks_sel, g_m, m_opt_sel)
        return cp_sel, c_opt_sel, masks_sel, m_opt_sel, ces.detach(), fracs

    def _selected_step(self, idx, acts, xs, ys):
        """Gather the selected clients' masks and mask-Adam rows (and,
        under the ablation, their towers, heads and client-Adam rows),
        run one global step on them, scatter them back; returns (ces,
        fracs)."""
        masks_sel = masks_mod.gather_clients(self.masks, idx)
        mopt_sel = masks_mod.gather_clients(self.m_opt, idx)
        if self.hp.server_grad_to_client:
            cp_sel = masks_mod.gather_clients(
                {"c": self.client_params, "p": self.proj_params}, idx)
            copt_sel = masks_mod.gather_clients(self.c_opt, idx)
            cp_sel, copt_sel, masks_sel, mopt_sel, ces, fracs = \
                self.global_joint_step(cp_sel, copt_sel, masks_sel,
                                       mopt_sel, xs[idx], ys[idx], acts[idx])
            self.client_params = masks_mod.scatter_clients(
                self.client_params, idx, cp_sel["c"])
            self.proj_params = masks_mod.scatter_clients(
                self.proj_params, idx, cp_sel["p"])
            self.c_opt = masks_mod.scatter_clients(self.c_opt, idx, copt_sel)
        else:
            masks_sel, mopt_sel, ces, fracs = self.global_step(
                masks_sel, mopt_sel, acts[idx], ys[idx])
        self.masks = masks_mod.scatter_clients(self.masks, idx, masks_sel)
        self.m_opt = masks_mod.scatter_clients(self.m_opt, idx, mopt_sel)
        return ces, fracs

    def _bill_payload(self, acts_shape, nnz):
        """One selected client's split payload (its own nnz fraction, or
        None: dense) and server FLOPs."""
        hp = self.hp
        self.meter.add_payload(split_payload_bytes(
            acts_shape, hp.batch_size, nnz_fraction=nnz,
            grad_down=hp.server_grad_to_client))
        self.meter.add_server_flops(3 * self._fl_s * hp.batch_size)

    def _global_iteration(self, selected, acts, ys, xs=None):
        """One batched global-phase iteration of the eager rung; exactly
        one device->host copy (the per-client CE losses and payload nnz
        fractions).  ``xs`` (the images) feed the joint step."""
        hp = self.hp
        idx = torch.as_tensor(np.asarray(selected), dtype=torch.int64,
                              device=self.device)
        ces, fracs = self._selected_step(idx, acts, xs, ys)
        losses, fracs = torch.stack([ces, fracs]).cpu().numpy()  # one sync
        for k in range(len(selected)):
            self._bill_payload(tuple(acts.shape[1:]),
                               float(fracs[k]) if hp.act_l1 else None)
        return [float(l) for l in losses]

    def _global_iteration_loop(self, selected, acts, ys, xs=None):
        """The seed's per-client host loop (``global_batch=False``, the
        reference's ``_global_iteration_loop``): ``server_step`` (or
        ``joint_step``) per selected client in turn, each client's state
        rows sliced out and written back.  Reads each client's CE, and
        its nnz fraction under ``act_l1``, once, and nothing else."""
        hp = self.hp
        losses = []
        for i in (int(i) for i in selected):
            a_i, nnz = acts[i], None
            if hp.act_l1:
                nz = a_i.abs() > hp.act_threshold
                nnz = float(nz.to(torch.float32).mean())
                a_i = torch.where(nz, a_i, torch.zeros((), device=a_i.device))
            mask_i, mopt_i = _row(self.masks, i), _row(self.m_opt, i)
            if hp.server_grad_to_client:
                cp_pp = {"c": self.client_params, "p": self.proj_params}
                cp_i, copt_i, mask_i, mopt_i, ce = self.joint_step(
                    _row(cp_pp, i), _row(self.c_opt, i), mask_i, mopt_i,
                    xs[i], ys[i])
                cp_pp = _set_row(cp_pp, i, cp_i)
                self.client_params, self.proj_params = cp_pp["c"], cp_pp["p"]
                self.c_opt = _set_row(self.c_opt, i, copt_i)
            else:
                mask_i, mopt_i, ce = self.server_step(mask_i, mopt_i, a_i,
                                                      ys[i])
            self.masks = _set_row(self.masks, i, mask_i)
            self.m_opt = _set_row(self.m_opt, i, mopt_i)
            losses.append(float(ce))
            self._bill_payload(tuple(a_i.shape), nnz)
        return losses

    def _staging_bytes_per_round(self, T: int) -> float:
        """H2D bytes of T iterations' (C, B) f32 images + int32 labels:
        billed alike by every rung (per iteration eager, per round or
        epoch chunk on the others), so the totals agree."""
        img = 4 * 3 * self.cfg.image_size ** 2
        return float(T * self.n * self.hp.batch_size * (img + 4))

    # ------------------------------------------------------------------
    def _epoch_batches(self, i):
        return batch_iterator(self.clients[i], self.hp.batch_size, self._rng)

    def train_iteration(self, xs, ys, global_phase: bool):
        """One eager protocol iteration on numpy batches (C, B, ...)/(C, B).
        Returns (selection, its CE losses, the (C,) client losses on the
        device); selection and CE are None in the local phase."""
        hp = self.hp
        xs = torch.from_numpy(xs).to(self.device)
        ys = torch.from_numpy(ys).to(self.device)
        acts, closs = self._client_step(xs, ys)
        # 3x forward FLOPs for fwd+bwd
        self.meter.add_client_flops(3 * self._fl_c * self.n * hp.batch_size)
        self.meter.add_host_device(self._staging_bytes_per_round(1))
        if not global_phase:
            return None, None, closs
        selected = self.orch.select()
        step = (self._global_iteration if hp.global_batch
                else self._global_iteration_loop)
        losses = step(selected, acts, ys, xs)
        self.orch.update(selected, losses)
        return selected, losses, closs

    def _run_round_eager(self, iters, T: int, global_phase: bool):
        """One round on the eager rung -> (summed client loss, CE losses)."""
        closs = torch.zeros((), device=self.device)
        ces = []
        for t in range(T):
            xs = np.stack([iters[i][t][0] for i in range(self.n)])
            ys = np.stack([iters[i][t][1] for i in range(self.n)])
            _, losses, cl = self.train_iteration(xs, ys, global_phase)
            closs = closs + cl.mean()
            ces += losses or []
        return float(closs), np.asarray(ces, np.float64)

    # ------------------------------------------------------------------
    # the round and epoch rungs: iterations resident on the device
    # ------------------------------------------------------------------
    def _device_iteration(self, x, y, jitter, ucb, global_phase: bool):
        """One iteration with no host read: the client step, then in the
        global phase ``ucb_select`` on ``jitter`` (N,), the selected
        step, and ``ucb_update`` from flags and losses scattered on the
        device.  Returns (bandit state, (C,) client losses, (idx, ces,
        fracs) or None)."""
        acts, closs = self._client_step(x, y)
        if not global_phase:
            return ucb, closs, None
        idx = ucb_select(ucb, self.orch.k, jitter)
        ces, fracs = self._selected_step(idx, acts, x, y)
        ucb = ucb_update_selected(ucb, idx, ces, n=self.n,
                                  gamma=self.hp.gamma)
        return ucb, closs, (idx, ces, fracs)

    def _device_round(self, staged, ucb, global_phase: bool):
        """The T iterations of one staged round (images, labels and, in
        the global phase, jitter, each with a leading T axis) ->
        (bandit state, summed client loss, per-iteration outputs)."""
        closs, outs = torch.zeros((), device=self.device), []
        for t in range(staged[0].shape[0]):
            ucb, cl, out = self._device_iteration(
                staged[0][t], staged[1][t],
                staged[2][t] if global_phase else None, ucb, global_phase)
            closs = closs + cl.mean()
            outs.append(out)
        return ucb, closs, outs

    def _stage_host(self, rounds, T: int):
        """Host-side staging: R rounds' per-client batch lists (of C
        clients, or of a streamed chunk's rows) as (R, T, C, B, ...)
        images and (R, T, C, B) labels, each batch written once, on the
        card into pinned memory (the source of an asynchronous copy)."""
        pin = self.device.type == "cuda"
        x0, y0 = rounds[0][0][0]
        n = len(rounds[0])
        out = []
        for j, a0 in enumerate((x0, y0)):
            buf = torch.empty((len(rounds), T, n) + a0.shape,
                              dtype=torch.from_numpy(a0).dtype,
                              pin_memory=pin)
            view = buf.numpy()
            for r, iters in enumerate(rounds):
                for t in range(T):
                    np.stack([iters[i][t][j] for i in range(n)],
                             out=view[r, t])
            out.append(buf)
        return out

    def _upload(self, host, stream=None):
        """Host tensors -> device tensors, and an event after their
        copies (None on the CPU or the current stream).  On the card each
        is copied from pinned memory without blocking, on ``stream`` (the
        current stream by default): a pageable copy would wait for the
        device."""
        if self.device.type != "cuda":
            return list(host), None
        host = [h if h.is_pinned() else h.pin_memory() for h in host]
        if stream is None:
            return [h.to(self.device, non_blocking=True) for h in host], None
        with torch.cuda.stream(stream):
            dev = [h.to(self.device, non_blocking=True) for h in host]
            done = torch.cuda.Event()
            done.record(stream)
        return dev, done

    def _adopt(self, staged):
        """Make the current stream wait for a side-stream upload, and
        tell the allocator the current stream uses its buffers, so none
        is reused before this stream is done with it."""
        dev, done = staged
        if done is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(done)
            for t in dev:
                t.record_stream(cur)
        return dev

    def _fetch(self, tensors):
        """The rungs' one device->host copy: ``tensors`` and the summed
        client losses of earlier local rounds (filled into their history
        records here), as one float32 transfer (client ids < 2**24 are
        exact).  Returns numpy arrays of the tensors' shapes."""
        pend, self._pending = self._pending, []
        parts = [p[1] for p in pend] + list(tensors)
        host = torch.cat([t.reshape(-1).to(torch.float32)
                          for t in parts]).cpu().numpy()
        out, i = [], 0
        for t in parts:
            out.append(host[i:i + t.numel()].reshape(tuple(t.shape)))
            i += t.numel()
        for (rec, _, T), v in zip(pend, out):
            rec["client_loss"] = float(v) / max(T, 1)
        return out[len(pend):]

    def _round_bill(self, T: int) -> dict:
        hp = self.hp
        return dict(acts_shape=(hp.batch_size,) + self._acts_spatial,
                    batch=hp.batch_size, n_clients=self.n, n_iters=T,
                    client_flops_per_example=self._fl_c,
                    server_flops_per_example=self._fl_s,
                    grad_down=hp.server_grad_to_client,
                    host_device_bytes=self._staging_bytes_per_round(T))

    def _run_round_scan(self, iters, T: int, global_phase: bool):
        """One round on the device from per-client batch lists: its
        (T, C, B, ...) batches and (T, N) jitter staged once, no host read
        inside the round, then one fetch in a global round (none in a
        local one: its client loss stays on the device until the next
        fetch) -> (summed client loss, CE losses (T*k,) or None)."""
        if T == 0:
            return 0.0, None
        xs, ys = self._stage_host([iters], T)
        host = [xs[0], ys[0]]
        if global_phase:
            host.append(self.orch.jitter_schedule(self.orch._n_selects, T))
        staged, _ = self._upload(host)
        ucb, closs, outs = self._device_round(staged, self.orch.state,
                                              global_phase)
        if global_phase:
            outs = tuple(torch.stack(o) for o in zip(*outs))
        return self._close_round(T, global_phase, ucb, closs, outs)

    def _close_round(self, T: int, global_phase: bool, ucb, closs, outs,
                     store_bytes: float = 0.0):
        """The round rungs' tail: bill the round (``store_bytes`` of a
        streamed round's store traffic on ``host_device_bytes`` besides)
        and, in a global round, fetch its outputs in the round's one sync
        and hand the selections to the orchestrator.  ``outs`` is (T, k)
        selections (device, or host when the caller read them already),
        CE losses and nnz fractions on the device -> (summed client loss,
        CE losses (T*k,) or None)."""
        bill = self._round_bill(T)
        bill["host_device_bytes"] += store_bytes
        if not global_phase:
            self.meter.ingest_round(n_selected=0, **bill)
            self.orch.state = ucb
            return closs, None
        idx, ces, fracs = outs
        on_device = torch.is_tensor(idx)
        got = self._fetch([closs, ces, fracs]
                          + ([idx] if on_device else []))  # one sync
        closs_h, ces_h, fracs_h = got[:3]
        idx_h = got[3] if on_device else idx
        self.meter.ingest_round(
            nnz_fracs=fracs_h if self.hp.act_l1 else None,
            n_selected=idx_h.shape[1], **bill)
        self.orch.ingest_round(idx_h.astype(np.int64), ces_h, state=ucb)
        return float(closs_h), ces_h.reshape(-1).astype(np.float64)

    def _run_epoch_scan(self, rounds_data, T: int, global_phase: bool):
        """Run an epoch of R rounds on the device, ``ucb_new_round`` at
        each boundary.

        rounds_data: per-round per-client batch lists (as ``train``
        draws them), or zero-argument callables making them, called in
        round order as each chunk is staged.  Rounds go up in chunks of
        ``epoch_chunk_rounds`` (0 = all R at once) through a two-slot
        ring: chunk k+1's upload is issued on a side stream before chunk
        k's compute, so the copy runs under it.  One fetch at the end of
        a global epoch, none in a local one.  Returns the per-round
        (summed client loss, CE losses) and cumulative meter summaries.
        """
        hp = self.hp
        R = len(rounds_data)
        if R == 0 or T == 0:
            return [], []
        chunk = max(1, min(hp.epoch_chunk_rounds or R, R))
        starts = list(range(0, R, chunk))
        base = self.orch._n_selects
        side = (torch.cuda.Stream(self.device)
                if self.device.type == "cuda" else None)

        def stage(r0):
            rc = min(chunk, R - r0)
            rounds = [rounds_data[r]() if callable(rounds_data[r])
                      else rounds_data[r] for r in range(r0, r0 + rc)]
            host = self._stage_host(rounds, T)
            if global_phase:
                host.append(self.orch.jitter_schedule(
                    base + r0 * T, rc * T).reshape(rc, T, self.n))
            return self._upload(host, side)

        ucb, closs, outs = self.orch.state, [], []
        ring = [stage(0)]
        for ci in range(len(starts)):
            staged = self._adopt(ring.pop(0))
            if ci + 1 < len(starts):
                ring.append(stage(starts[ci + 1]))
            for r in range(staged[0].shape[0]):
                ucb = ucb_new_round(ucb, gamma=hp.gamma)
                ucb, cl, out = self._device_round([a[r] for a in staged],
                                                  ucb, global_phase)
                closs.append(cl)
                outs += out
            del staged

        if global_phase:
            outs = tuple(torch.stack(o).reshape((R, T) + o[0].shape)
                         for o in zip(*outs))
        return self._close_epoch(R, T, global_phase, ucb, closs, outs)

    def _close_epoch(self, R: int, T: int, global_phase: bool, ucb, closs,
                     outs, store_bytes: float = 0.0):
        """The epoch rung's tail, as :meth:`_close_round` for R rounds:
        one ``ingest_epoch`` bill, and in a global epoch the epoch's one
        fetch of (R, T, k) outputs -> (per-round (summed client loss, CE
        losses), cumulative meter summaries)."""
        bill = self._round_bill(T)
        bill["host_device_bytes"] += store_bytes
        if not global_phase:
            summaries = self.meter.ingest_epoch(n_rounds=R, n_selected=0,
                                                **bill)
            self.orch.ingest_epoch(None, None, state=ucb, n_rounds=R)
            return [(cl, None) for cl in closs], summaries
        idx, ces, fracs = outs
        on_device = torch.is_tensor(idx)
        got = self._fetch([torch.stack(closs), ces, fracs]
                          + ([idx] if on_device else []))  # the epoch sync
        closs_h, ces_h, fracs_h = got[:3]
        idx_h = got[3] if on_device else idx
        summaries = self.meter.ingest_epoch(
            n_rounds=R, nnz_fracs=fracs_h if self.hp.act_l1 else None,
            n_selected=idx_h.shape[-1], **bill)
        self.orch.ingest_epoch(idx_h.astype(np.int64), ces_h, state=ucb)
        return ([(float(closs_h[r]), ces_h[r].reshape(-1).astype(np.float64))
                 for r in range(R)], summaries)

    # ------------------------------------------------------------------
    # streamed residency: client state in a store, O(chunk) + O(S) rows
    # on the device
    # ------------------------------------------------------------------
    def _init_streamed_store(self, gen, acts_dim: int):
        """Fill the client store chunk by chunk, never making the stacked
        (C, ...) trees: every client tower first, then every projection
        head, drawn from ``gen`` in the resident init's order, so a
        streamed trainer starts from exactly the resident trainer's
        state; masks are ones and the Adam states zeros."""
        hp, cfg, n = self.hp, self.cfg, self.n
        self.store = make_store(hp.store_backend, n, directory=hp.store_dir,
                                pin=self.device.type == "cuda")
        meta = torch.device("meta")
        one = torch.Generator().manual_seed(0)     # shapes only
        cp = {"c": lenet.init_client_params(cfg, one),
              "p": _proj_init(one, acts_dim, hp.proj_dim)}
        cp = tree_map(lambda l: torch.empty((n,) + tuple(l.shape),
                                            dtype=l.dtype, device=meta), cp)
        masks = self._init_masks(n, meta)
        groups = {"cp": cp, "co": self._client_opt(cp), "m": masks,
                  "mo": self._client_opt(masks)}
        for name, tree in groups.items():
            self.store.alloc(name, tree)
        chunks = [np.arange(i0, min(n, i0 + self._stream_chunk))
                  for i0 in range(0, n, self._stream_chunk)]
        for part, draw in (
                ("c", lambda: lenet.init_client_params(cfg, gen)),
                ("p", lambda: _proj_init(gen, acts_dim, hp.proj_dim))):
            for rows in chunks:
                self.store.scatter(rows, {"cp": {
                    part: _stack([draw() for _ in rows])}})

        def filled(tree, value, m):
            return tree_map(lambda l: torch.full(
                (m,) + tuple(l.shape[1:]), value, dtype=l.dtype), tree)
        for rows in chunks:
            self.store.scatter(rows, {"co": filled(groups["co"], 0, len(rows)),
                                      "m": filled(masks, 1, len(rows)),
                                      "mo": filled(groups["mo"], 0,
                                                   len(rows))})

    def _stream_store_bytes(self, T: int, global_phase: bool) -> float:
        """Host<->device bytes of ONE streamed round's store traffic, on
        top of the data staging every rung bills (the reference's
        formula): every client's params/opt row up and down once and its
        (T, B, ...) split activations down in the client pass; per global
        iteration the S selected clients' mask/opt rows up and down and
        their activations and labels up again.  Host and disk rows have
        the same bytes, so the bill does not depend on the backend."""
        hp = self.hp
        act = 4 * int(np.prod(self._acts_spatial))
        b = 2.0 * self.store.nbytes(("cp", "co"))
        b += float(T * self.n * hp.batch_size * act)
        if global_phase:
            row = self.store.row_nbytes(("m", "mo"))
            payload = hp.batch_size * (act + 4)
            b += float(T * self.orch.k * (2 * row + payload))
        return b

    def _put(self, tree):
        """A tree of host tensors on the device (without blocking, from
        pinned memory, on the card)."""
        dev, _ = self._upload(tree_leaves(tree))
        return tree_unflatten(tree, dev)

    def _client_pass(self, iters, T: int):
        """Pass A: every client's T client steps, ``stream_chunk`` rows at
        a time, its params/opt rows gathered from the store and scattered
        back.  On the round and epoch rungs each chunk's batches and rows
        go up through a two-slot ring: chunk k+1's gather and upload run
        (on a side stream) under chunk k's steps; on the eager rung each
        iteration's batch goes up on its own.  Each chunk's split
        activations and rows come down in ONE host sync, the activations
        into a host buffer for pass B.  Returns (activations (T, C, B,
        ...) and labels (T, C, B) on the host, per-client losses (T, C)
        on the device)."""
        n, chunk = self.n, self._stream_chunk
        ring_rung = self.hp.round_scan
        side = (torch.cuda.Stream(self.device)
                if ring_rung and self.device.type == "cuda" else None)
        pin = self.device.type == "cuda"
        starts = list(range(0, n, chunk))

        def stage(i0):
            rows = np.arange(i0, min(n, i0 + chunk))
            xs, ys = self._stage_host([iters[i0:i0 + len(rows)]], T)
            g = self.store.gather(rows, ("cp", "co"))
            if not ring_rung:
                return rows, xs[0], ys[0], self._put(g)
            return rows, ys[0], g, self._upload(
                [xs[0], ys[0]] + tree_leaves(g), side)

        acts_h = ys_h = None
        losses = torch.empty((T, n), device=self.device)
        ring = [stage(0)]
        for ci in range(len(starts)):
            if ring_rung:
                rows, ys_host, g, staged = ring.pop(0)
                xs_d, ys_d, *leaves = self._adopt(staged)
                g = tree_unflatten(g, leaves)
            else:
                rows, xs_host, ys_host, g = ring.pop(0)
            cp, co = g["cp"], g["co"]
            acts, loss = [], []
            for t in range(T):
                if ring_rung:
                    x, y = xs_d[t], ys_d[t]
                else:
                    (x, y), _ = self._upload([xs_host[t], ys_host[t]])
                cp, co, a, l = self._client_step_rows(cp, co, x, y)
                acts.append(a)
                loss.append(l)
            losses[:, rows[0]:rows[-1] + 1] = torch.stack(loss)
            if ci + 1 < len(starts):
                ring.append(stage(starts[ci + 1]))
            host = to_host({"acts": torch.stack(acts), "cp": cp,
                            "co": co})                    # the one sync
            if acts_h is None:
                a0 = host["acts"]
                acts_h = torch.empty((T, n) + tuple(a0.shape[2:]),
                                     dtype=a0.dtype, pin_memory=pin)
                ys_h = torch.empty((T, n) + tuple(ys_host.shape[2:]),
                                   dtype=ys_host.dtype, pin_memory=pin)
            acts_h[:, rows[0]:rows[-1] + 1] = host["acts"]
            ys_h[:, rows[0]:rows[-1] + 1] = ys_host
            self.store.scatter(rows, {"cp": host["cp"], "co": host["co"]})
        return acts_h, ys_h, losses

    def _stream_one_round(self, ucb, t_base: int, iters, T: int,
                          global_phase: bool):
        """One streamed round over the client store, as two passes that
        commute exactly with the resident interleaving (client steps
        never read what global steps write; the ``server_grad_to_client``
        ablation, which breaks this, falls back to resident at init).

        Pass A (:meth:`_client_pass`) runs every client's T steps chunk
        by chunk.  Pass B replays the round's global iterations on the
        spilled activations: each selects FIRST on the device-resident
        bandit state (``Orchestrator.select_on``), reads the selection,
        gathers only the S selected clients' mask and mask-Adam rows and
        activations, runs ``global_step`` and scatters the rows back;
        ``Orchestrator.update_on`` updates the bandit state.

        Host syncs, on the card: ceil(C / stream_chunk) in pass A (one
        per chunk: its activation spill and row scatter) and 2T in pass B
        (per iteration the selection read and the mask rows' scatter);
        the round's one fetch (the epoch's, on the epoch rung) is the
        caller's.  Nothing else waits for the device.

        Returns (bandit state, summed mean client loss on the device,
        host selections (T, k) and device (T, k) CE losses and nnz
        fractions, or None in a local round); bills nothing."""
        acts_h, ys_h, losses = self._client_pass(iters, T)
        closs = torch.zeros((), device=self.device)
        for t in range(T):
            closs = closs + losses[t].mean()
        if not global_phase:
            return ucb, closs, None
        pin = self.device.type == "cuda"

        def rows_of(h, idx):
            out = torch.empty((len(idx),) + tuple(h.shape[1:]),
                              dtype=h.dtype, pin_memory=pin)
            return torch.index_select(h, 0, idx, out=out)

        idx_l, ces_l, fracs_l = [], [], []
        for t in range(T):
            idx = self.orch.select_on(ucb, t_base + t)
            idx_h = idx.cpu()                 # the selection read (a sync)
            sel = self._put({"rows": self.store.gather(idx_h.numpy(),
                                                       ("m", "mo")),
                             "acts": rows_of(acts_h[t], idx_h),
                             "ys": rows_of(ys_h[t], idx_h)})
            m_sel, mo_sel, ces, fracs = self.global_step(
                sel["rows"]["m"], sel["rows"]["mo"], sel["acts"], sel["ys"])
            ucb = self.orch.update_on(ucb, idx, ces)
            self.store.scatter(idx_h.numpy(), {"m": m_sel, "mo": mo_sel})
            idx_l.append(idx_h.numpy())
            ces_l.append(ces)
            fracs_l.append(fracs)
        return ucb, closs, (np.stack(idx_l), torch.stack(ces_l),
                            torch.stack(fracs_l))

    def _run_round_streamed(self, iters, T: int, global_phase: bool):
        """The streamed counterpart of ``_run_round_scan`` on the eager or
        round rung: the same ``ingest_round`` arguments, so the protocol
        channels bill as the resident rungs do, and the store's traffic
        added on ``host_device_bytes``; one fetch in a global round, none
        in a local one -> (summed client loss, CE losses or None)."""
        if T == 0:
            return 0.0, None
        ucb, closs, outs = self._stream_one_round(
            self.orch.state, self.orch._n_selects, iters, T, global_phase)
        return self._close_round(T, global_phase, ucb, closs, outs,
                                 self._stream_store_bytes(T, global_phase))

    def _run_epoch_streamed(self, R: int, T: int, global_phase: bool,
                            make_round):
        """The streamed counterpart of ``_run_epoch_scan``: R streamed
        rounds (``make_round()`` draws each one's batches) with
        ``ucb_new_round`` applied on the device at each boundary, one
        fetch at the end of a global epoch, billed by one
        ``ingest_epoch`` -> (per-round (client loss, CE losses),
        cumulative meter summaries)."""
        ucb, base = self.orch.state, self.orch._n_selects
        closs, outs = [], []
        for r in range(R):
            ucb = ucb_new_round(ucb, gamma=self.hp.gamma)
            ucb, cl, out = self._stream_one_round(ucb, base + r * T,
                                                  make_round(), T,
                                                  global_phase)
            closs.append(cl)
            outs.append(out)
        if global_phase:
            outs = (np.stack([o[0] for o in outs]),
                    torch.stack([o[1] for o in outs]),
                    torch.stack([o[2] for o in outs]))
        return self._close_epoch(R, T, global_phase, ucb, closs, outs,
                                 self._stream_store_bytes(T, global_phase))

    # ------------------------------------------------------------------
    def _record(self, r: int, global_phase: bool, T: int, closs, ces,
                summary: dict, evaluate: bool):
        """Append round r's history record: the meter totals, the mean
        client loss (filled in at the next fetch while it is still a
        device tensor), the mean server CE, and the accuracy at eval
        points."""
        rec = {"round": r, "phase": "global" if global_phase else "local",
               "client_loss": None,
               "ce": float(np.mean(ces)) if ces is not None and len(ces)
               else None,
               **summary}
        if torch.is_tensor(closs):
            self._pending.append((rec, closs, T))
        else:
            rec["client_loss"] = closs / max(T, 1)
        if evaluate:
            rec["accuracy"] = self.evaluate()
        self.history.append(rec)

    def train(self, eval_every: int = 1):
        """Run ``hp.rounds`` rounds on the rung the hparams pick; one
        history record per round with the meter totals, the mean client
        loss and the mean server CE of the round, and the accuracy at
        eval points."""
        hp = self.hp
        # the per-client loop runs on the eager rung whatever the rungs'
        # flags say, as in the reference
        batched = hp.round_scan and hp.global_batch
        if batched and hp.epoch_scan:
            return self._train_epoch_scan(eval_every)
        local_rounds = int(round(hp.kappa * hp.rounds))
        run_round = (self._run_round_streamed if self._streamed
                     else self._run_round_scan if batched
                     else self._run_round_eager)
        for r in range(hp.rounds):
            global_phase = r >= local_rounds
            self.orch.new_round()
            iters = [list(self._epoch_batches(i)) for i in range(self.n)]
            T = min(len(it) for it in iters)
            closs, ces = run_round(iters, T, global_phase)
            self._record(r, global_phase, T, closs, ces,
                         self.meter.summary(),
                         (r + 1) % eval_every == 0 or r == hp.rounds - 1)
        if self._pending:
            self._fetch([])
        return self.history

    def _train_epoch_scan(self, eval_every: int):
        """The epoch rung: consecutive rounds of one phase form an epoch,
        cut at eval points (where the host needs the params anyway), each
        run by ``_run_epoch_scan``; the per-round records are rebuilt
        from the epoch's outputs."""
        hp = self.hp
        local_rounds = int(round(hp.kappa * hp.rounds))
        # batch_iterator drops the remainder, so T follows from the sizes
        T = min(len(c.x) // hp.batch_size for c in self.clients)

        def is_eval(r):
            return (r + 1) % eval_every == 0 or r == hp.rounds - 1

        def make_round():
            """One round's batches, drawn from the same per-client RNG
            stream in the same order as the other rungs."""
            return [list(self._epoch_batches(i)) for i in range(self.n)]

        r = 0
        while r < hp.rounds:
            global_phase = r >= local_rounds
            end = r
            while (end + 1 < hp.rounds and not is_eval(end)
                   and ((end + 1) >= local_rounds) == global_phase):
                end += 1
            R = end - r + 1
            if T == 0:
                # nothing to run, but the other rungs reset the bandit
                # every round
                for _ in range(R):
                    self.orch.new_round()
                results = [(0.0, None)] * R
                summaries = [self.meter.summary()] * R
            elif self._streamed:
                results, summaries = self._run_epoch_streamed(
                    R, T, global_phase, make_round)
            else:
                results, summaries = self._run_epoch_scan(
                    [make_round] * R, T, global_phase)
            for j, rr in enumerate(range(r, end + 1)):
                self._record(rr, global_phase, T, *results[j], summaries[j],
                             is_eval(rr))
            r = end + 1
        if self._pending:
            self._fetch([])
        return self.history

    # ------------------------------------------------------------------
    @torch.no_grad()
    def _eval_logits(self, client_params, masks, xs):
        """Logits of every client on its own test inputs, stacked."""
        hp, cfg, kw = self.hp, self.cfg, self._fwd_kw
        acts = lenet.client_forward(cfg, client_params, xs, **kw)
        if hp.mask_mode == "per_scalar":
            eff = masks_mod.apply_scalar_masks(self.server_params, masks)
            logits, _ = lenet.server_forward(cfg, eff, acts, **kw)
        else:
            logits, _ = lenet.server_forward(cfg, self.server_params, acts,
                                             gates=masks, **kw)
        return logits

    def client_accuracies(self) -> np.ndarray:
        """(C,) per-client test accuracy in [0, 1]."""
        if self._streamed:
            return self._client_accuracies_streamed()
        shapes = {cd.test_x.shape for cd in self.clients}
        if len(shapes) == 1:
            xs = torch.from_numpy(np.stack(
                [cd.test_x for cd in self.clients])).to(self.device)
            ys = torch.from_numpy(np.stack(
                [cd.test_y for cd in self.clients])).to(self.device)
            return accuracy(self._eval_logits(
                self.client_params, self.masks, xs), ys).cpu().numpy()
        accs = []
        for i, cd in enumerate(self.clients):
            row = torch.tensor([i], device=self.device)
            xs = torch.from_numpy(cd.test_x[None]).to(self.device)
            ys = torch.from_numpy(cd.test_y[None]).to(self.device)
            accs.append(float(accuracy(self._eval_logits(
                masks_mod.gather_clients(self.client_params, row),
                masks_mod.gather_clients(self.masks, row), xs), ys)[0]))
        return np.asarray(accs, np.float32)

    def _client_accuracies_streamed(self) -> np.ndarray:
        """:meth:`client_accuracies` over the client store: its towers and
        masks go up ``stream_chunk`` rows at a time (one row at a time
        where the test sets differ in size)."""
        same = len({cd.test_x.shape for cd in self.clients}) == 1
        step = self._stream_chunk if same else 1
        accs = []
        for i0 in range(0, self.n, step):
            rows = np.arange(i0, min(self.n, i0 + step))
            g = self._put(self.store.gather(rows, ("cp", "m")))
            xs, ys = (torch.from_numpy(np.stack(
                [getattr(self.clients[i], f) for i in rows])).to(self.device)
                for f in ("test_x", "test_y"))
            accs.append(accuracy(self._eval_logits(g["cp"]["c"], g["m"], xs),
                                 ys))
        return torch.cat(accs).cpu().numpy()

    def evaluate(self) -> float:
        return 100.0 * float(np.mean(self.client_accuracies()))

    def c3(self, bandwidth_budget, compute_budget, temperature=8.0):
        acc = self.history[-1].get("accuracy") or self.evaluate()
        return c3_score(acc, self.meter.bandwidth_gb,
                        self.meter.client_tflops,
                        bandwidth_budget=bandwidth_budget,
                        compute_budget=compute_budget,
                        temperature=temperature)
