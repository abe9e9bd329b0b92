"""Host- and disk-backed stores of stacked per-client training state
(port of ``repro.core.client_store``).

The resident trainer keeps every client's params, Adam moments and masks
on the device as stacked (C, ...) leaves: O(C) device memory, for a
protocol whose rounds touch all C clients only in the client pass and
the S = eta*N selected ones in each global step.  With
``AdaSplitHParams.streamed`` the per-client trees live in a
:class:`ClientStore` and only the rows a pass touches go up to the
device, as dense (chunk, ...) or (S, ...) trees (the streamed rounds of
``core/adasplit.py``).

Two backends over one row-indexed contract:

* :class:`HostStore`: leaves are CPU tensors, page-locked when the
  trainer runs on a card, so a gather fills page-locked staging that
  uploads without blocking; the population is bounded by host memory.
* :class:`DiskStore`: leaves are writable ``np.memmap`` views over a
  ``checkpoint/io.py`` directory checkpoint (one raw ``.npy`` per
  leaf), so k rows read or write O(k) rows of disk and the population
  is bounded by disk.  ``flush()`` leaves a checkpoint that
  ``open_checkpoint_dir`` reads from another process.

The store's tree is a DICT of named groups (the trainer's ``"cp"``,
``"co"``, ``"m"``, ``"mo"``), so a pass gathers only the groups it needs.
Every leaf has a leading client axis C; ``rows`` are global client ids
(host integers).  ``gather`` returns CPU tensors; ``scatter`` takes CPU
or CUDA tensors or numpy arrays.
"""
from __future__ import annotations

import os
import tempfile
from typing import Any, Dict, Iterable, Optional

import numpy as np
import torch

from repro_torch.checkpoint.io import (alloc_checkpoint_dir,
                                       open_checkpoint_dir)
from repro_torch.core.masks import host_gather_clients, host_scatter_clients
from repro_torch.weights import tree_leaves, tree_map


def _itemsize(dtype) -> int:
    if isinstance(dtype, torch.dtype):
        return dtype.itemsize
    return np.dtype(dtype).itemsize


def tree_nbytes(tree) -> int:
    """Total bytes of a tree of arrays or tensors (host or device)."""
    return sum(int(np.prod(tuple(l.shape))) * _itemsize(l.dtype)
               for l in tree_leaves(tree))


def _subset(groups: Dict[str, Any], keys: Optional[Iterable[str]]):
    if keys is None:
        return groups
    return {k: groups[k] for k in keys}


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, np.dtype(dtype))).dtype


class ClientStore:
    """Row-indexed host/disk store of stacked (C, ...) client trees."""

    def __init__(self, n: int, *, pin: bool = False):
        self.n = int(n)
        self.pin = bool(pin)
        self._groups: Dict[str, Any] = {}

    # -- population -----------------------------------------------------
    def adopt(self, groups: Dict[str, Any]):
        """Take in whole (C, ...) group trees (their values copied)."""
        for name, tree in groups.items():
            self.alloc(name, tree)
            self.scatter(np.arange(self.n), {name: tree})
        return self

    def alloc(self, name: str, template):
        """Allocate one named group from a tree of (C, ...) leaves that
        carry a shape and a dtype (tensors, ``meta`` ones included, or
        arrays; values are NOT copied); fill it with :meth:`scatter`."""
        raise NotImplementedError

    # -- row access ------------------------------------------------------
    def gather(self, rows, keys: Optional[Iterable[str]] = None):
        """Dense (k, ...) CPU copies of ``rows`` of the named groups (all
        when ``keys`` is None), page-locked when the store pins."""
        return host_gather_clients(_subset(self._groups, keys), rows,
                                   pin=self.pin)

    def scatter(self, rows, groups: Dict[str, Any]):
        """Write (k, ...) rows back.  ``groups`` holds some of the
        store's groups, or parts of them; CUDA rows come to the host in
        one stream sync (the stream's device->host edge)."""
        host_scatter_clients(_subset(self._groups, list(groups)), rows,
                             groups)

    def full(self, keys: Optional[Iterable[str]] = None):
        """The whole (C, ...) population as CPU tensors (tests and
        evaluation at small C: O(C) host memory by definition)."""
        return host_gather_clients(_subset(self._groups, keys),
                                   np.arange(self.n))

    # -- accounting ------------------------------------------------------
    def nbytes(self, keys: Optional[Iterable[str]] = None) -> int:
        return tree_nbytes(_subset(self._groups, keys))

    def row_nbytes(self, keys: Optional[Iterable[str]] = None) -> int:
        """Bytes of ONE client's row across the named groups: the unit of
        the streamed path's host<->device billing."""
        return self.nbytes(keys) // max(self.n, 1)

    def flush(self):
        pass


class HostStore(ClientStore):
    """Leaves are CPU tensors (population bounded by host memory),
    page-locked when ``pin``."""

    def alloc(self, name: str, template):
        self._groups[name] = tree_map(
            lambda l: torch.empty(tuple(l.shape), dtype=_torch_dtype(l.dtype),
                                  pin_memory=self.pin), template)


class DiskStore(ClientStore):
    """Leaves are writable memmaps over a ``checkpoint/io`` directory
    checkpoint per group (population bounded by disk; O(k) row IO)."""

    def __init__(self, n: int, directory: Optional[str] = None, *,
                 pin: bool = False):
        super().__init__(n, pin=pin)
        self.directory = directory or tempfile.mkdtemp(
            prefix="adasplit_client_store_")

    def alloc(self, name: str, template):
        self._groups[name] = alloc_checkpoint_dir(
            os.path.join(self.directory, name), template,
            metadata={"group": name, "n_clients": self.n})

    def flush(self):
        for tree in self._groups.values():
            for l in tree_leaves(tree):
                l.flush()

    def reopen(self, name: str, like):
        """Open a flushed group again read-only through
        ``open_checkpoint_dir`` (``like`` carries the (C, ...) tree
        structure)."""
        self.flush()
        return open_checkpoint_dir(os.path.join(self.directory, name),
                                   like, mode="r")


def make_store(backend: str, n: int, *, directory: Optional[str] = None,
               pin: bool = False) -> ClientStore:
    if backend == "host":
        return HostStore(n, pin=pin)
    if backend == "disk":
        return DiskStore(n, directory, pin=pin)
    raise ValueError(f"unknown client-store backend {backend!r} "
                     "(expected 'host' or 'disk')")
