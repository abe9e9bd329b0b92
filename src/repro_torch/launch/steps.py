"""Step functions of the LM path (port of ``repro.launch.steps``): the
train half (``LaunchPolicy``, ``init_train_state``, the AdaSplit train
step, its in-step UCB selection and its window of steps) and the serve
half (``_cast_params``'s rule, applied per leaf as ``_cast_leaf``, and
``init_serve_params``).

The train step is the LM variant of the AdaSplit protocol:

* client cohorts: the reference's ``data`` mesh axis, here a leading
  cohort axis of ``n_cohorts`` on every client leaf.  Each cohort's
  client sub-model trains with the supervised NT-Xent loss on its rows'
  sequence-class labels (the cohort id), with NO gradient from the
  server: the split activations are detached (P_si = 0).  The C
  cohorts' projections go through the NT-Xent kernel as one (C, b, P)
  batch: one forward and one backward launch a step on the card.
* server: chunked CE + lambda * L1 over the per-cohort structured
  masks + ``router_aux_coef`` x the server's MoE router aux loss (0 for
  a stack without a router; the client's aux stays out of the client
  loss, as in the reference); the cohort selection enters as a (C,)
  ``select`` weight vector.
* one ``adam_update`` over the whole trainables (client order, one
  scalar step): ``plan_launches`` launches of the multi-tensor Adam
  kernel on the card.

Attention in the train step is the reference's training attention
(``models.attention.training_attention``, asked for with
``training=True``): the flash kernel has no backward.  The reference's
mesh placement of the LM state and the dry-run builders are not ported
(the sharding rules are, in ``repro_torch.sharding``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.configs.base import LONG_CONTEXT_WINDOW, InputShape
from repro_torch.core import masks as masks_mod
from repro_torch.core.losses import chunked_cross_entropy, l1_penalty
from repro_torch.core.orchestrator import n_selected, ucb_select, ucb_update
from repro_torch.kernels.client_conv import client_proj
from repro_torch.kernels.ntxent import ntxent_loss
from repro_torch.models import transformer as tfm
from repro_torch.optim.adam import adam_init, adam_update
from repro_torch.weights import (tree_leaves, tree_map, tree_unflatten,
                                 tree_unstack)


# ---------------------------------------------------------------------------
# Launch policy
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class LaunchPolicy:
    """The reference's policy fields that something in the port reads.
    Its sharding fields (``fsdp``, ``seq_shard``, ``attn_*_shard``/
    ``_pin``, ``moe_batch_pin``) wait for their reader, the LM state's
    placement over a (data, model) mesh (ROADMAP queue 1 item 6);
    ``microbatch`` is the number of grad-accumulation chunks per
    step."""
    microbatch: int = 1
    remat: bool = True
    param_dtype: str = "bfloat16"  # large-leaf param dtype (moments f32)
    lr: float = 1e-3
    tau: float = 0.07
    lam: float = 1e-5
    proj_dim: int = 64
    ce_chunk: int = 512
    n_seq_classes: int = 16       # NT-Xent sequence-class label space


def default_policy(cfg, shape: Optional[InputShape] = None,
                   data_size: int = 16) -> LaunchPolicy:
    """The reference's baseline policy, sized for a v5e's memory:
    ``microbatch`` doubles until the per-rank remat scan carry (n_layers x
    b_local x S x D x 2 B) is under ~3 GB, where a model above 10 B
    params has that carry divided by the model axis (16), which its
    sequence sharding splits.  That model also gets ``fsdp`` and
    ``seq_shard`` in the reference; the port reads neither yet."""
    big = cfg.param_count() > 10e9
    mb = 1
    if shape is not None and shape.kind == "train" and not cfg.is_conv:
        b_local = max(shape.global_batch // data_size, 1)
        carry = (cfg.n_layers + cfg.n_encoder_layers) * b_local \
            * shape.seq_len * cfg.d_model * 2
        if big:
            carry /= 16
        budget = 3e9
        while mb < b_local and carry / mb > budget:
            mb *= 2
    return LaunchPolicy(microbatch=mb)


def _cast_leaf(p, dt, shape=None):
    """``dt`` for a large matmul leaf (>= 2 dims and >= 65,536 elements,
    stacked axes counted); small and 1-D leaves (norm scales, biases)
    stay float32.  ``shape``: the whole leaf's, where ``p`` is one row
    of it (the row is cast as the whole leaf would be)."""
    shape = tuple(p.shape) if shape is None else tuple(shape)
    if p.dtype == torch.float32 and len(shape) >= 2 \
            and math.prod(shape) >= 1 << 16:
        return p.to(dt)
    return p


def arch_window(cfg, shape: InputShape) -> int:
    """Sliding window used for this (arch, shape): the config's own, or
    the long-context window at ``long_500k`` of an arch that needs one
    (``supports_long_context() == "windowed"``: not a pure SSM stack,
    whose decode is native at any length)."""
    if cfg.sliding_window:
        return cfg.sliding_window
    if shape.name == "long_500k" \
            and cfg.supports_long_context() == "windowed":
        return LONG_CONTEXT_WINDOW
    return 0


# ---------------------------------------------------------------------------
# Train state
# ---------------------------------------------------------------------------


def _generator(seed, device):
    if isinstance(seed, torch.Generator):
        return seed
    return torch.Generator(device=device).manual_seed(int(seed))


def _proj_init(gen, d_model, proj_dim):
    draw = lambda shape: torch.randn(shape, generator=gen, device=gen.device,
                                     dtype=torch.float32)
    return {"w1": draw((d_model, 128)) / math.sqrt(d_model),
            "b1": torch.zeros((128,), device=gen.device),
            "w2": draw((128, proj_dim)) / math.sqrt(128)}


def init_train_state(cfg, n_cohorts: int, policy: LaunchPolicy, seed=0, *,
                     device="cuda"):
    """Trainables + Adam state, random from ``seed`` (an int, or a
    ``torch.Generator`` whose device the draws are made on) on
    ``device``.  Client leaves have a leading cohort dim; large leaves
    are cast to ``policy.param_dtype`` after the stacking (the stacked
    size decides, as the reference casts the stacked tree); the masks
    and the Adam moments stay float32."""
    gen = _generator(seed, device)
    dt = getattr(torch, policy.param_dtype)
    cast = lambda t, shape=None: _cast_leaf(t.to(device), dt, shape)
    clients = [{"model": tfm.init_client_params(cfg, gen),
                "proj": _proj_init(gen, cfg.d_model, policy.proj_dim)}
               for _ in range(n_cohorts)]
    client = tree_map(lambda *xs: cast(torch.stack(xs)), *clients)
    del clients
    server = tree_map(cast, tfm.init_server_params(cfg, gen, cast))
    trainables = {"client": client, "server": server,
                  "masks": masks_mod.init_unit_masks(cfg, n_cohorts,
                                                     device=device)}
    return {"trainables": trainables, "opt": adam_init(trainables)}


# ---------------------------------------------------------------------------
# Train step (AdaSplit global phase)
# ---------------------------------------------------------------------------

# the modality inputs a batch may carry beside its tokens
EXTRAS = ("src_embeds", "vision_embeds", "positions")


def build_train_step(cfg, shape: InputShape,
                     policy: Optional[LaunchPolicy] = None, *,
                     n_cohorts: int = 1):
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    batch: ``tokens``/``labels`` (B, S) int, ``seq_class`` (B,) int and
    ``select`` (C,) float32, on the state's device, rows cohort-major
    (B = C x b); and the modality inputs where the arch takes them
    (``EXTRAS``: an encoder-decoder's ``src_embeds`` (B, S, D), a
    vision-text arch's ``vision_embeds`` (B, F, D) and ``positions``
    (B, S, 3)), split with the rows into each cohort's client forward
    and into the server forward.  metrics: ``l_client``, ``ce`` and
    ``aux`` (the server's router aux loss, before its coefficient), 0-d
    float32 device tensors (the means over the microbatch chunks)."""
    policy = policy or LaunchPolicy()
    C = n_cohorts
    B, S = shape.global_batch, shape.seq_len
    if B % C:
        raise ValueError(f"global batch {B} does not split over {C} cohorts")
    b = B // C
    window = arch_window(cfg, shape)
    n_micro = max(1, min(policy.microbatch, b))
    while b % n_micro:
        n_micro -= 1
    mb = b // n_micro
    f32 = torch.float32

    def micro_loss(trainables, mtokens, mlabels, mseq_class, select,
                   extras):
        dev = mtokens.device
        # --- client: per-cohort NT-Xent ---
        tk = mtokens.reshape(C, mb, S)
        sc = mseq_class.reshape(C, mb)
        ex_c = {k: e.reshape((C, mb) + tuple(e.shape[1:]))
                for k, e in extras.items()}
        cohorts = tree_unstack(trainables["client"]["model"], C)
        acts = torch.stack([tfm.client_forward(
            cfg, cohorts[c], tk[c], {k: e[c] for k, e in ex_c.items()},
            training=True, remat=policy.remat)
            for c in range(C)])                             # (C, mb, S, D)
        pooled = acts.to(f32).mean(dim=2)                    # (C, mb, D)
        q = client_proj(trainables["client"]["proj"], pooled)
        l_client = ntxent_loss(q, sc, policy.tau).mean()

        # --- server: CE + lambda*L1(masks), detached split ---
        acts_flat = acts.detach().reshape(C * mb, S, -1)
        client_ids = torch.arange(C, device=dev).repeat_interleave(mb)
        gates = masks_mod.expand_gates(trainables["masks"], client_ids)
        hidden, aux = tfm.server_forward(
            cfg, trainables["server"], acts_flat, mtokens, extras,
            gates=gates, window=window, training=True, remat=policy.remat,
            return_hidden=True)
        w = select[client_ids][:, None] * torch.ones((1, S), dtype=f32,
                                                     device=dev)
        ce = chunked_cross_entropy(hidden,
                                   trainables["server"]["lm_head"]["table"],
                                   mlabels, cfg.vocab_size,
                                   chunk=policy.ce_chunk, weights=w)
        l_server = ce + policy.lam * l1_penalty(trainables["masks"]) \
            + cfg.router_aux_coef * aux
        return l_client + l_server, (l_client, ce, aux)

    def grads_of(leaves, mtokens, mlabels, mseq_class, select, extras, like):
        params = [l.detach().requires_grad_(True) for l in leaves]
        loss, terms = micro_loss(tree_unflatten(like, params), mtokens,
                                 mlabels, mseq_class, select, extras)
        g = torch.autograd.grad(loss, params, allow_unused=True)
        g = [torch.zeros_like(p) if gi is None else gi
             for p, gi in zip(params, g)]
        return g, [t.detach() for t in terms]

    def split(x):
        # (B, ...) = (C, b, ...) -> (n_micro, C*mb, ...)
        y = x.reshape((C, n_micro, mb) + tuple(x.shape[1:]))
        return y.transpose(0, 1).reshape((n_micro, C * mb)
                                         + tuple(x.shape[1:]))

    def train_step(state, batch):
        trainables, opt = state["trainables"], state["opt"]
        leaves = tree_leaves(trainables)
        toks, labs = split(batch["tokens"]), split(batch["labels"])
        scls = split(batch["seq_class"])
        exs = {k: split(batch[k]) for k in EXTRAS if k in batch}
        micro = lambda i: {k: e[i] for k, e in exs.items()}
        if n_micro == 1:
            grads, terms = grads_of(leaves, toks[0], labs[0], scls[0],
                                    batch["select"], micro(0), trainables)
        else:
            grads = [torch.zeros(l.shape, dtype=f32, device=l.device)
                     for l in leaves]
            terms = [torch.zeros((), dtype=f32, device=leaves[0].device)] * 3
            for i in range(n_micro):
                g, ti = grads_of(leaves, toks[i], labs[i], scls[i],
                                 batch["select"], micro(i), trainables)
                grads = [a + gi for a, gi in zip(grads, g)]
                terms = [a + t for a, t in zip(terms, ti)]
            grads = [g / n_micro for g in grads]
            terms = [t / n_micro for t in terms]
        new_t, new_opt = adam_update(trainables,
                                     tree_unflatten(trainables, grads), opt,
                                     lr=policy.lr)
        return ({"trainables": new_t, "opt": new_opt},
                dict(zip(("l_client", "ce", "aux"), terms)))

    return train_step


def build_ucb_train_step(cfg, shape: InputShape,
                         policy: Optional[LaunchPolicy] = None, *,
                         n_cohorts: int = 1, eta: float = 0.6,
                         gamma: float = 0.87):
    """``build_train_step`` with the UCB orchestrator in the step.
    Returns ``(ucb_step, k)``, ``k`` the cohorts a global step selects:

      ucb_step(state, ucb, batch, jitter, is_global) -> (state, ucb, metrics)

    A global step selects on the device from the bandit state with
    ``jitter`` ((C,) uniform [0, 1) draws, the reference's keyed jitter),
    trains with that ``select``, and folds the step's CE, broadcast to
    every cohort, into the state.  A local step (``is_global`` false, a
    host bool: the port runs eagerly, where the reference traces one
    graph for both phases) trains with ``select = 0`` and keeps the
    state.  ``metrics["select"]`` is the (C,) selection."""
    fn = build_train_step(cfg, shape, policy, n_cohorts=n_cohorts)
    C = n_cohorts
    k = n_selected(C, eta)

    def ucb_step(state, ucb, batch, jitter, is_global):
        sel = torch.zeros((C,), dtype=torch.float32,
                          device=batch["tokens"].device)
        if is_global:
            sel = sel.index_fill(0, ucb_select(ucb, k, jitter), 1.0)
        state, metrics = fn(state, dict(batch, select=sel))
        if is_global:
            ucb = ucb_update(ucb, sel, metrics["ce"].reshape(1).expand(C),
                             gamma=gamma)
        return state, ucb, dict(metrics, select=sel)

    return ucb_step, k


def build_windowed_ucb_step(cfg, shape: InputShape,
                            policy: Optional[LaunchPolicy] = None, *,
                            n_cohorts: int = 1, eta: float = 0.6,
                            gamma: float = 0.87):
    """``build_ucb_train_step`` over a whole metrics window; returns
    ``(window_step, k)`` (see :func:`wrap_window`)."""
    ucb_step, k = build_ucb_train_step(cfg, shape, policy,
                                       n_cohorts=n_cohorts, eta=eta,
                                       gamma=gamma)
    return wrap_window(ucb_step), k


def wrap_window(ucb_step):
    """The window over an already-built ``ucb_step``:

      window_step(carry, batches, jitters, is_global) -> metrics

    ``carry`` is a dict holding ``state`` and ``ucb``, replaced in it
    step by step (where the reference returns them): a caller that
    keeps only the dict keeps no step's state past its step, so a
    window holds one train state as the per-step driver does, not its
    first state beside its last.  ``batches`` holds (W, ...) leaves,
    ``jitters`` (W, C) draws and ``is_global`` W host bools (a window
    may straddle the phase switch); the returned metrics hold (W, ...)
    leaves, the steps' metrics stacked."""

    def window_step(carry, batches, jitters, is_global):
        out = []
        for i, g in enumerate(is_global):
            carry["state"], carry["ucb"], m = ucb_step(
                carry["state"], carry["ucb"],
                {k: v[i] for k, v in batches.items()}, jitters[i], bool(g))
            out.append(m)
        return {k: torch.stack([m[k] for m in out]) for k in out[0]}

    return window_step


# ---------------------------------------------------------------------------
# Serve params
# ---------------------------------------------------------------------------


def init_serve_params(cfg, seed=0, dtype: str = "bfloat16", *,
                      device="cuda"):
    """One client's model + the server model, random from ``seed`` (an
    int, or a ``torch.Generator`` whose device the draws are made on),
    on ``device``.  An int seeds a generator on ``device``, so a
    full-width init is drawn on the card.  Each weight is moved and cast
    as it is drawn, and a stacked expert leaf one ``n_rep`` row at a
    time, so the peak is the cast model plus one float32 dense leaf or
    expert row (granite-3-8b in bf16: ~23 GB, where the whole float32
    tree beside its bf16 copy was ~50 GB; qwen3-moe-30b-a3b: 61.1 GB
    plus a 0.81 GB row, where its server's stacked float32 ``w_gate``
    alone is 30.6 GB); the values are those of casting the whole
    float32 tree."""
    gen = _generator(seed, device)
    dt = getattr(torch, dtype) if isinstance(dtype, str) else dtype

    def cast(t, shape=None):
        return _cast_leaf(t.to(device), dt, shape)
    params = {"client": tfm.init_client_params(cfg, gen, cast),
              "server": tfm.init_server_params(cfg, gen, cast)}
    return tree_map(cast, params)
