"""AdaSplit per-client server masks (§3.3, eq. 7-8): the LeNet half and
the transformer half (port of ``repro.core.masks``).

* ``per_scalar`` — one mask value per server parameter, applied by
  transforming the params before the forward (``apply_scalar_masks``),
  so grads are masked by the chain rule — exactly eq. 7.
* ``per_unit`` — one mask value per conv output channel / FC hidden
  unit / attention head / MLP hidden unit / expert / mamba inner
  channel, applied in
  activation space as gates, or folded into the server weights for
  serving (``fold_unit_masks``).

Mask leaves are continuous, init 1.0, driven sparse by the L1 term;
``binarize`` thresholds them and ``sparsity`` reports the fraction of
zeros.  All trees are stacked with a leading client axis.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.transformer import Segment, server_plan
from repro_torch.weights import to_host, tree_leaves, tree_map


# ---------------------------------------------------------------------------
# per-unit masks (transformer stack)
# ---------------------------------------------------------------------------


def _seg_unit_masks(cfg, seg: Segment, n_clients: int, device):
    def one(desc):
        m = {}
        units = cfg.n_heads if desc.mixer == "attn" else cfg.d_inner
        m["mixer"] = torch.ones((n_clients, seg.n_rep, units), device=device)
        if desc.ffn == "dense":
            m["ffn"] = torch.ones((n_clients, seg.n_rep, cfg.d_ff),
                                  device=device)
        elif desc.ffn == "moe":
            m["ffn"] = torch.ones((n_clients, seg.n_rep, cfg.n_experts),
                                  device=device)
        return m
    return {str(j): one(d) for j, d in enumerate(seg.body)}


def init_unit_masks(cfg, n_clients: int, device="cuda"):
    """One entry per server segment (an encoder-decoder's decoder
    segments: its encoder and cross-attentions stay ungated, as in the
    reference): leaves (C, n_rep, U)."""
    return [_seg_unit_masks(cfg, s, n_clients, device)
            for s in server_plan(cfg)]


def expand_gates(masks, client_ids):
    """Per-example gates: leaves (C, n_rep, U) -> (n_rep, B, U)."""
    ids = torch.as_tensor(client_ids, dtype=torch.long)
    return [tree_map(lambda l: l[ids.to(l.device)].transpose(0, 1), seg)
            for seg in masks]


def gates_for_client(masks, client: int):
    """Single-client gates: leaves (n_rep, U)."""
    return [tree_map(lambda l: l[client], seg) for seg in masks]


def stack_client_gates(per_client_gates):
    """Stack per-client gate trees (leaves (n_rep, U)) into per-example
    gates (leaves (n_rep, B, U)) for a mixed-client serving batch."""
    return [tree_map(lambda *ls: torch.stack(ls, dim=1), *seg)
            for seg in zip(*per_client_gates)]


def init_slot_gates(masks, n_slots: int):
    """All-ones per-slot gate stack (leaves ``(n_rep, n_slots, U)``) for
    the continuous-batching engine: a free slot decodes through the
    unmasked server (its row is never read), an occupied slot carries
    its client's gates, written in by :func:`set_slot_gates`."""
    return [tree_map(lambda l: torch.ones(
        (l.shape[1], n_slots) + tuple(l.shape[2:]), dtype=l.dtype,
        device=l.device), seg) for seg in masks]


def set_slot_gates(slot_gates, slot: int, client_gates):
    """Write one client's gate tree (leaves ``(n_rep, U)``) into column
    ``slot`` of the per-slot stack (leaves ``(n_rep, B, U)``), in place,
    and return the stack."""
    tree_map(lambda s, c: s[:, slot].copy_(c), slot_gates, client_gates)
    return slot_gates


def fold_unit_masks(cfg, server_params, masks, client: int, *,
                    threshold: float = 0.0):
    """Fold client ``client``'s per-unit masks into the server weights.

    Equivalent to gating at every step (gating a unit's output == scaling
    the rows of the following projection: the attention ``wo`` rows of
    a head, the mamba ``out_proj`` row of an inner channel, the
    ``w_down`` rows of an MLP hidden unit, the whole ``w_down`` of an
    expert), but paid ONCE per serving session.  An encoder-decoder
    folds into its decoder's self-attentions and ffns.  threshold > 0
    binarises first.  Only ``wo``, ``out_proj`` and ``w_down`` are
    copied; every other leaf is shared with ``server_params``."""
    gates = gates_for_client(masks, client)
    if threshold > 0:
        gates = binarize(gates, threshold)
    new_segments = []
    for seg, sp, gs in zip(server_plan(cfg), server_params["segments"],
                           gates):
        sp = list(sp)
        for j, desc in enumerate(seg.body):
            layer = dict(sp[j])
            g = gs[str(j)]
            if g.get("mixer") is not None:
                gm = g["mixer"]          # (n_rep, H) attn, (n_rep, din) ssm
                mixer = dict(layer["mixer"])
                if desc.mixer == "attn":
                    rows = gm.repeat_interleave(cfg.head_dim, dim=-1)
                    mixer["wo"] = mixer["wo"] * rows[..., None].to(
                        mixer["wo"].dtype)
                else:
                    mixer["out_proj"] = mixer["out_proj"] \
                        * gm[..., None].to(mixer["out_proj"].dtype)
                layer["mixer"] = mixer
            if g.get("ffn") is not None and "ffn" in layer:
                gf = g["ffn"]                    # (n_rep, F) or (n_rep, E)
                ffn = dict(layer["ffn"])
                # an expert's w_down is (F, D): scale it whole
                gf = gf[..., None, None] if desc.ffn == "moe" else \
                    gf[..., None]
                ffn["w_down"] = ffn["w_down"] * gf.to(ffn["w_down"].dtype)
                layer["ffn"] = ffn
            sp[j] = layer
        new_segments.append(sp)
    out = dict(server_params)
    out["segments"] = new_segments
    return out


def init_lenet_unit_masks(cfg, n_clients: int, device="cuda"):
    from repro_torch.models.lenet import split_index
    s = split_index(cfg)
    ones = lambda u: torch.ones((n_clients, u), device=device)
    return {"blocks": [ones(c) for c in cfg.conv_channels[s:]],
            "fc1": ones(120), "fc2": ones(cfg.d_model)}


def init_scalar_masks(server_params, n_clients: int):
    return tree_map(lambda p: torch.ones((n_clients,) + tuple(p.shape),
                                         dtype=p.dtype, device=p.device),
                    server_params)


def apply_scalar_masks(server_params, mask):
    """Effective server model M^s * m_i (eq. 7 via the chain rule); a
    stacked (S, ...) mask gives stacked effective weights."""
    return tree_map(lambda p, m: p * m.to(p.dtype), server_params, mask)


def gather_clients(tree, idx):
    """Every leaf (C, ...) -> (S, ...) rows ``idx``."""
    return tree_map(lambda l: l[idx], tree)


def scatter_clients(tree, idx, new):
    """Inverse of :func:`gather_clients`: a copy of ``tree`` with rows
    ``idx`` replaced by ``new``'s (S, ...) leaves."""
    return tree_map(lambda l, n: l.index_copy(0, idx, n.to(l.dtype)),
                    tree, new)


def host_gather_clients(tree, idx, *, pin: bool = False):
    """Host-side :func:`gather_clients`: leaves are CPU tensors or numpy
    arrays (``np.memmap`` disk views included), ``idx`` host ids; the
    result is a dense (S, ...) CPU tensor per leaf, written straight into
    page-locked memory when ``pin`` (the source of a non-blocking
    upload; a fancy index of a pinned tensor would land in pageable
    memory).  Only the requested rows are read: the O(k) contract of the
    streamed client store."""
    idx = np.asarray(idx, np.int64)
    tidx = torch.from_numpy(idx)

    def take(l):
        shape = (len(idx),) + tuple(l.shape[1:])
        if torch.is_tensor(l):
            out = torch.empty(shape, dtype=l.dtype, pin_memory=pin)
            return torch.index_select(l, 0, tidx, out=out)
        dtype = torch.from_numpy(np.empty(0, l.dtype)).dtype
        out = torch.empty(shape, dtype=dtype, pin_memory=pin)
        np.take(l, idx, axis=0, out=out.numpy())
        return out
    return tree_map(take, tree)


def host_scatter_clients(tree, idx, new):
    """Host-side :func:`scatter_clients`: writes the (S, ...) rows of
    ``new`` into the leaves of ``tree`` (CPU tensors or numpy/memmap
    arrays) IN PLACE, cast to each leaf's dtype.  ``new`` may hold CUDA
    tensors (the stream's device->host edge: ``weights.to_host``, one
    sync)
    and may be a subtree: its structure is walked, so a group can be
    written a part at a time.  Returns ``tree``."""
    idx = np.asarray(idx, np.int64)
    tidx = torch.from_numpy(idx)

    def put(src, dst):
        if torch.is_tensor(dst):
            src = torch.as_tensor(src)
            dst.index_copy_(0, tidx, src.to(dst.dtype))
            return
        if torch.is_tensor(src):
            src = (src.contiguous().view(torch.int16).numpy().view(np.uint16)
                   if src.dtype == torch.bfloat16      # disk view: the bits
                   else src.numpy())
        dst[idx] = src
    tree_map(put, to_host(new), tree)
    return tree


def binarize(masks, threshold: float = 0.05):
    return tree_map(lambda m: (m.abs() > threshold).to(m.dtype), masks)


def sparsity(masks, threshold: float = 0.05) -> float:
    leaves = tree_leaves(masks)
    zero = sum(float((m.abs() <= threshold).sum()) for m in leaves)
    tot = sum(m.numel() for m in leaves)
    return zero / max(tot, 1)
