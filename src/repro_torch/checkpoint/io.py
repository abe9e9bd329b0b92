"""Checkpoint IO (port of ``repro.checkpoint.io``): trees <-> ``.npz``
with path-flattened keys, or <-> a directory of one raw ``.npy`` per
leaf, each with a JSON sidecar.

Keys flatten as the reference's do: dict keys (walked in sorted order,
as ``weights.tree_map`` walks them) and list indices joined by ``/``.
Leaves may be numpy arrays or torch tensors.  bfloat16 is stored as its
``uint16`` bit pattern (numpy has no bfloat16 of its own; the bits go
through an integer view, never a float cast), so for the same tree the
``.npz`` members and the ``leaf_%05d.npy`` files hold the reference's
bytes.

The sidecar is JSON, not the reference's msgpack (the machines the port
runs on have no msgpack), and so it has its own file name
(``<path>.json`` beside an ``.npz``, ``checkpoint.json`` in a
directory): neither package finds, and misreads, the other's.

* ``save_checkpoint`` / ``restore_checkpoint``: ONE ``.npz`` archive;
  ``rows=`` slices each leaf after the whole member is read.
* ``save_checkpoint_dir`` / ``alloc_checkpoint_dir`` /
  ``open_checkpoint_dir``: one raw ``.npy`` per leaf, named by the
  flattened keys' order (kept in the sidecar), memory-mappable, so k
  rows of a stacked (C, ...) leaf read or write O(k) rows of disk: the
  backend of ``core/client_store.DiskStore``.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.weights import tree_unflatten

DIR_SIDECAR = "checkpoint.json"


def _flatten(tree, prefix: str = "") -> Dict[str, Any]:
    """``{"a/b/0": leaf, ...}`` in leaf order."""
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), t) for i, t in enumerate(tree)]
    else:
        return {prefix: tree}
    flat = {}
    for k, t in items:
        flat.update(_flatten(t, f"{prefix}/{k}" if prefix else k))
    return flat


def _disk_dtype(dtype) -> Tuple[np.dtype, str]:
    """(numpy dtype written to disk, logical dtype name) of a torch or
    numpy dtype; bfloat16 goes to disk as uint16."""
    if isinstance(dtype, torch.dtype):
        if dtype == torch.bfloat16:
            return np.dtype(np.uint16), "bfloat16"
        dtype = torch.empty(0, dtype=dtype).numpy().dtype
    dt = np.dtype(dtype)
    if dt.name == "bfloat16":
        return np.dtype(np.uint16), "bfloat16"
    return dt, str(dt)


def _to_disk_view(a) -> Tuple[np.ndarray, str]:
    """(host array of the leaf's disk bytes, logical dtype name)."""
    if torch.is_tensor(a):
        t = a.detach().cpu()
        if t.dtype == torch.bfloat16:
            return (t.contiguous().view(torch.int16).numpy().view(np.uint16),
                    "bfloat16")
        a = t.numpy()
    a = np.asarray(a)
    disk, name = _disk_dtype(a.dtype)
    return a.view(disk), name


def from_disk_view(a, dtype: str) -> torch.Tensor:
    """Invert the disk view on an array (or sliced rows of one): a CPU
    tensor of the logical dtype (a read-only map is copied first)."""
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:
        a = a.copy()
    if dtype == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _write_sidecar(path: str, keys, dtypes, shapes, metadata):
    with open(path, "w") as f:
        json.dump({"keys": keys, "dtypes": dtypes, "shapes": shapes,
                   "metadata": metadata or {}}, f)


def _read_sidecar(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def save_checkpoint(path: str, tree, metadata: Optional[dict] = None):
    """``<path>.npz`` (one member per flattened key) and ``<path>.json``
    (the ordered keys, logical dtypes and shapes, and ``metadata``)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays, dtypes, shapes = {}, {}, {}
    for k, v in _flatten(tree).items():
        arrays[k], dtypes[k] = _to_disk_view(v)
        shapes[k] = list(arrays[k].shape)
    np.savez(path + ".npz", **arrays)
    _write_sidecar(path + ".json", list(arrays), dtypes, shapes, metadata)


def restore_checkpoint(path: str, like, rows=None) -> Tuple[Any, dict]:
    """Restore into the structure of ``like`` as CPU tensors.  Returns
    (tree, metadata).  ``rows`` (a leading-axis index) slices every
    leaf after it is read, so stacked (C, ...) client leaves restore as
    the k requested rows (``like`` need only have the structure)."""
    meta = _read_sidecar(path + ".json")
    leaves = []
    with np.load(path + ".npz") as data:
        for k in _flatten(like):
            a = data[k]
            if rows is not None:
                a = a[rows]
            leaves.append(from_disk_view(a, meta["dtypes"][k]))
    return tree_unflatten(like, leaves), meta["metadata"]


# ---------------------------------------------------------------------------
# directory layout: one raw .npy per leaf, memory-mappable row access
# ---------------------------------------------------------------------------


def _leaf_path(path: str, i: int) -> str:
    return os.path.join(path, f"leaf_{i:05d}.npy")


def save_checkpoint_dir(path: str, tree, metadata: Optional[dict] = None):
    """One raw ``.npy`` per leaf under directory ``path``, and the
    sidecar with the ordered key list, so the leaves can be opened again
    as writable memory maps by :func:`open_checkpoint_dir`."""
    os.makedirs(path, exist_ok=True)
    keys, dtypes, shapes = [], {}, {}
    for i, (k, v) in enumerate(_flatten(tree).items()):
        a, dtypes[k] = _to_disk_view(v)
        np.save(_leaf_path(path, i), a)
        keys.append(k)
        shapes[k] = list(a.shape)
    _write_sidecar(os.path.join(path, DIR_SIDECAR), keys, dtypes, shapes,
                   metadata)


def alloc_checkpoint_dir(path: str, like, metadata: Optional[dict] = None):
    """A :func:`save_checkpoint_dir`-layout checkpoint of ``like``'s
    shapes and dtypes with no array made: every leaf an uninitialised
    writable memmap (``open_memmap(mode="w+")``).  ``like``'s leaves need
    only ``shape`` and ``dtype`` (torch, ``meta`` tensors included, or
    numpy).  Returns the tree of memmaps, to be filled range by range."""
    os.makedirs(path, exist_ok=True)
    keys, dtypes, shapes, mms = [], {}, {}, []
    for i, (k, a) in enumerate(_flatten(like).items()):
        disk, dtypes[k] = _disk_dtype(a.dtype)
        shape = tuple(int(s) for s in a.shape)
        mms.append(np.lib.format.open_memmap(_leaf_path(path, i), mode="w+",
                                             dtype=disk, shape=shape))
        keys.append(k)
        shapes[k] = list(shape)
    _write_sidecar(os.path.join(path, DIR_SIDECAR), keys, dtypes, shapes,
                   metadata)
    return tree_unflatten(like, mms)


def open_checkpoint_dir(path: str, like, *, mode: str = "r"
                        ) -> Tuple[Any, dict]:
    """Open a directory checkpoint as a tree of ``np.memmap`` leaves (the
    structure of ``like``) without reading the arrays: ``leaf[rows]``
    then reads O(k) rows of disk.  Returns (tree of memmaps, metadata).
    ``mode="r+"`` maps them writable.

    The leaves are raw disk views: bfloat16 leaves come out as uint16
    and go through :func:`from_disk_view` after slicing (the sidecar's
    dtypes, also under ``metadata["_dtypes"]``, say which)."""
    meta = _read_sidecar(os.path.join(path, DIR_SIDECAR))
    keys = meta["keys"]
    want = list(_flatten(like))
    if want != keys:
        raise ValueError(f"checkpoint dir {path} keys {keys} do not match "
                         f"`like` keys {want}")
    mms = [np.load(_leaf_path(path, i), mmap_mode=mode)
           for i in range(len(keys))]
    md = dict(meta["metadata"])
    md["_dtypes"] = meta["dtypes"]
    return tree_unflatten(like, mms), md

