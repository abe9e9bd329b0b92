"""Sharding policy of the port: param tree -> partition-spec tree (port of
``repro.sharding.rules``).

Axes
----
``model``            Megatron tensor parallel (heads / ffn / experts /
                     mamba channels / vocab).
``data`` (+``pod``)  batch / client-cohort axis; AdaSplit client params
                     carry a leading cohort dim sharded here.  FSDP /
                     ZeRO additionally shard large leaves on this axis.

A spec is a :class:`P`: one entry per dim, an axis name, a tuple of
names or None (the contents of the reference's ``PartitionSpec``).
Rules are matched on the (parent-key, leaf-key) path through the port's
param trees (nested dicts and lists, the reference's keys) and read
only each leaf's shape, so meta tensors and arrays do as well as
tensors.  Every rule checks divisibility and falls back to replication.

The cohort rules (``cohort_pspecs``, ``staged_cohort_spec``) lay out
the cohort-sharded trainer (``core/adasplit.py``).  The model-axis
rules are pure; their consumer, the LM train state's placement over a
(data, model) mesh, is still to come with the launch tooling.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np


class P(tuple):
    """A partition spec: per-dim axis names (or None), as a tuple."""

    def __new__(cls, *dims):
        return super().__new__(cls, dims)

    def __repr__(self):
        return f"P{tuple(self)!r}"


@dataclass(frozen=True)
class MeshAxes:
    """Logical axis names for the active mesh."""
    model: Optional[str] = "model"
    data: Tuple[str, ...] = ("data",)     # ("pod", "data") when multi-pod
    model_size: int = 1
    data_size: int = 1

    @staticmethod
    def from_mesh(mesh) -> "MeshAxes":
        names = mesh.axis_names
        data = tuple(n for n in names if n in ("pod", "data"))
        dsz = int(np.prod([mesh.shape[n] for n in data])) if data else 1
        msz = mesh.shape["model"] if "model" in names else 1
        return MeshAxes(model="model" if "model" in names else None,
                        data=data, model_size=msz, data_size=dsz)

    @property
    def data_spec(self):
        return self.data if len(self.data) > 1 \
            else (self.data[0] if self.data else None)


# ---------------------------------------------------------------------------
# tree walks (specs are tuples, so a P is a leaf, never a branch)
# ---------------------------------------------------------------------------


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, tree[k], path + (str(k),))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        return type(tree)(_map_with_path(fn, t, path + (f"[{i}]",))
                          for i, t in enumerate(tree))
    return fn(path, tree)


def _map(fn, tree, *rest):
    return _map_with_path(
        lambda path, leaf: fn(leaf, *(_at(r, path) for r in rest)), tree)


def _at(tree, path):
    for k in path:
        tree = tree[int(k[1:-1])] if k.startswith("[") else tree[k]
    return tree


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(getattr(leaf, "shape", ()))


def _div(n: int, by: int) -> bool:
    return by > 0 and n % by == 0


# ---------------------------------------------------------------------------
# Core rule: one leaf -> list of dim assignments
# ---------------------------------------------------------------------------


def _base_spec(keys: Tuple[str, ...], shape: Tuple[int, ...], cfg,
               ax: MeshAxes) -> list:
    """Model-axis assignment per dim (list of axis-name-or-None)."""
    spec: list = [None] * len(shape)
    M = ax.model_size
    if ax.model is None or M <= 1:
        return spec
    leaf = keys[-1]
    parent = keys[-2] if len(keys) >= 2 else ""
    last, second = len(shape) - 1, len(shape) - 2

    # --- embeddings: shard padded vocab ---
    if leaf == "table":
        if _div(shape[-2], M):
            spec[second] = ax.model
        return spec

    # --- attention (incl. cross); leaf names are attention-specific ---
    if parent in ("mixer", "cross") and leaf in ("wq", "wk", "wv", "wo",
                                                 "bq", "bk", "bv"):
        heads_ok = _div(cfg.n_heads, M)
        kv_ok = _div(cfg.n_kv_heads, M)
        if leaf in ("wq", "bq") and heads_ok:
            spec[last] = ax.model
        elif leaf in ("wk", "wv", "bk", "bv") and heads_ok and kv_ok:
            spec[last] = ax.model
        elif leaf == "wo" and heads_ok:
            spec[second] = ax.model
        return spec

    # --- mamba mixer; leaf names are ssm-specific ---
    if parent == "mixer" and cfg.ssm_state:
        if not (_div(cfg.d_inner, M) and _div(cfg.ssm_nheads, M)):
            return spec
        if leaf in ("in_proj", "A_log", "D", "dt_bias", "norm_scale"):
            # in_proj's fused [z | xBC | dt] output dim: every component
            # width divides by M (checked above for d_inner / H)
            spec[last] = ax.model
        elif leaf == "out_proj":
            spec[second] = ax.model
        # conv_w / conv_b: channels din + 2GN, whose 2GN tail breaks even
        # splits; replicated (small: C x K)
        return spec

    # --- MoE ---
    if parent == "ffn" and cfg.n_experts and leaf in ("w_gate", "w_up",
                                                      "w_down"):
        # stacked experts (.., E, D, F): expert parallel on E
        if len(shape) >= 3 and _div(shape[-3], M):
            spec[len(shape) - 3] = ax.model
        return spec
    if leaf == "router":
        return spec  # replicated: router logits feed a global top-k
    if parent in ("shared", "ffn"):
        # shared experts and the dense MLP: column then row parallel
        if leaf in ("w_gate", "w_up") and _div(shape[-1], M):
            spec[last] = ax.model
        elif leaf == "w_down" and _div(shape[-2], M):
            spec[second] = ax.model
        return spec

    # --- frontend projector (vlm/audio stub): column parallel ---
    if leaf == "frontend_proj" and _div(shape[-1], M):
        spec[last] = ax.model
        return spec

    # norms, biases, lenet convs, projection heads: replicated
    return spec


def _add_fsdp(spec: list, shape: Tuple[int, ...], ax: MeshAxes, *,
              skip_dims: Sequence[int] = (), min_size: int = 1 << 22
              ) -> list:
    """Additionally shard the largest free dim on the data axes (ZeRO /
    FSDP).  Never touches the scan (n_rep) dim or already-sharded dims."""
    if not ax.data or ax.data_size <= 1:
        return spec
    if int(np.prod(shape)) < min_size:
        return spec
    cands = [d for d in range(len(shape))
             if spec[d] is None and d not in skip_dims
             and _div(shape[d], ax.data_size)]
    if not cands:
        return spec
    d = max(cands, key=lambda i: shape[i])
    spec = list(spec)
    spec[d] = ax.data_spec
    return spec


def _is_stacked(keys: Tuple[str, ...]) -> bool:
    return any(k in ("segments", "enc_segments") for k in keys)


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------


def server_pspecs(cfg, params, ax: MeshAxes, *, fsdp: bool = False):
    """Specs for the server param tree."""
    def one(keys, leaf):
        shape = _shape(leaf)
        spec = _base_spec(keys, shape, cfg, ax)
        if fsdp:
            skip = (0,) if _is_stacked(keys) else ()
            spec = _add_fsdp(spec, shape, ax, skip_dims=skip)
        return P(*spec)
    return _map_with_path(one, params)


def client_pspecs(cfg, params, ax: MeshAxes, *, cohort_dim: bool = True):
    """Client param tree; leaves optionally carry a leading cohort dim
    sharded on the data axes (one cohort per data slice)."""
    def one(keys, leaf):
        shape = _shape(leaf)[1:] if cohort_dim else _shape(leaf)
        spec = _base_spec(keys, shape, cfg, ax)
        if cohort_dim:
            spec = [ax.data_spec] + spec
        return P(*spec)
    return _map_with_path(one, params)


def opt_pspecs(param_specs, params, ax: MeshAxes, *, zero: bool = True):
    """Adam state specs: mu/nu follow the param spec, plus ZeRO-1 extra
    sharding of large replicated dims over data.  ``step`` is
    replicated."""
    def one(ps, leaf):
        shape = _shape(leaf)
        spec = list(ps) + [None] * (len(shape) - len(ps))
        if zero:
            used = {a for s in spec if s is not None
                    for a in ((s,) if isinstance(s, str) else s)}
            if not (set(ax.data) & used):
                spec = _add_fsdp(spec, shape, ax,
                                 skip_dims=(0,) if len(shape) > 2 else ())
        return P(*spec)
    mu = _map(one, param_specs, params)
    return {"mu": mu, "nu": mu, "step": P()}


def mask_pspecs(cfg, masks, ax: MeshAxes):
    """AdaSplit per-unit masks: leaves (C, n_rep, U) -> cohort on data,
    units on model where divisible."""
    def one(leaf):
        shape = _shape(leaf)
        spec = [ax.data_spec] + [None] * (len(shape) - 1)
        if len(shape) >= 2 and ax.model and _div(shape[-1], ax.model_size):
            spec[-1] = ax.model
        return P(*spec)
    return _map(one, masks)


def cache_pspecs(cfg, cache, ax: MeshAxes, *, batch_shardable: bool = True):
    """KV / SSM cache specs.

    kv leaves under segments: (n_rep, B, L, Hkv, hd): batch on data,
    heads on model if divisible else head_dim on model.  ssm state:
    (n_rep, B, H, P, N): H on model.  conv: replicated tail."""
    M = ax.model_size
    bspec = ax.data_spec if batch_shardable else None

    def one(keys, leaf):
        shape = _shape(leaf)
        nd = len(shape)
        spec = [None] * nd
        # every cache leaf under segments leads with n_rep, then batch
        if nd >= 2:
            spec[1] = bspec
        if keys[-1] in ("k", "v", "cross_k", "cross_v"):
            if nd >= 5:
                if _div(shape[-2], M):
                    spec[-2] = ax.model
                elif _div(shape[-1], M):
                    spec[-1] = ax.model
        elif keys[-1] == "state":
            if nd >= 5 and _div(shape[2], M):
                spec[2] = ax.model
        return P(*spec)
    return _map_with_path(one, cache)


def batch_spec(ax: MeshAxes, ndim: int, *, batch_dim: int = 0):
    spec = [None] * ndim
    spec[batch_dim] = ax.data_spec
    return P(*spec)


def cohort_pspecs(tree, ax: MeshAxes, *, cohort_size: Optional[int] = None):
    """Leading-cohort-dim specs for any stacked per-client tree (client
    params, projection heads, Adam moments, masks, the UCB state alike):
    every leaf whose leading dim is the cohort axis gets ``P(data, None,
    ...)``; scalar leaves (the UCB ``t`` counter) and leaves whose
    leading dim does not divide by the data axes are replicated.

    ``cohort_size``: when given, only leaves whose dim 0 equals it are
    candidates (for trees where some leaves carry no cohort dim); when
    None, any leading dim divisible by ``ax.data_size`` shards."""
    def one(leaf):
        shape = _shape(leaf)
        if (not ax.data or ax.data_size <= 1 or not shape
                or (cohort_size is not None and shape[0] != cohort_size)
                or not _div(shape[0], ax.data_size)):
            return P()
        return P(*([ax.data_spec] + [None] * (len(shape) - 1)))
    return _map(one, tree)


def staged_cohort_spec(ax: MeshAxes, ndim: int, *, cohort_dim: int = 1):
    """Spec for staged round/epoch data: (T, C, B, ...) with
    ``cohort_dim=1`` (per-round staging) or (R, T, C, B, ...) with
    ``cohort_dim=2`` (epoch chunks): the cohort axis on ``data``,
    everything else replicated."""
    return batch_spec(ax, ndim, batch_dim=cohort_dim)
