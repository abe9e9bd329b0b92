"""Sharded LRU cache for per-client serving state.

At "millions of users" the per-client gate stack IS the serving working
set (ROADMAP): every admitted request needs its client's binarized gate
pytree, and a single flat OrderedDict becomes one global hot structure.
``ShardedLRU`` splits the capacity over independent shards keyed by
``client_id % n_shards`` — eviction pressure in one shard never evicts
another shard's hot entries, and the layout maps 1:1 onto a future
multi-process server (shard = owning worker).

With ``n_shards=1`` it degrades to a plain exact LRU (the legacy
engine's behaviour, kept for the differential tests).
"""
from __future__ import annotations

import collections
import math
from typing import Any, Callable, List


class ShardedLRU:
    """LRU cache sharded by key.  Integer keys shard by ``key % n_shards``
    (uniform for rotating client ids); other keys by ``hash``."""

    def __init__(self, capacity: int, n_shards: int = 1):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.n_shards = max(1, min(int(n_shards), int(capacity)))
        self.shard_capacity = math.ceil(capacity / self.n_shards)
        self._shards: List["collections.OrderedDict[Any, Any]"] = [
            collections.OrderedDict() for _ in range(self.n_shards)]
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    @property
    def capacity(self) -> int:
        return self.shard_capacity * self.n_shards

    def _shard(self, key) -> "collections.OrderedDict[Any, Any]":
        i = key % self.n_shards if isinstance(key, int) \
            else hash(key) % self.n_shards
        return self._shards[i]

    def get_or_add(self, key, factory: Callable[[], Any]):
        """Return the cached value, building + inserting via ``factory``
        on a miss (evicting the shard's LRU entry if full)."""
        shard = self._shard(key)
        if key in shard:
            self.hits += 1
            shard.move_to_end(key)
            return shard[key]
        self.misses += 1
        value = shard[key] = factory()
        if len(shard) > self.shard_capacity:
            shard.popitem(last=False)
            self.evictions += 1
        return value

    def __contains__(self, key) -> bool:
        return key in self._shard(key)

    def __len__(self) -> int:
        return sum(len(s) for s in self._shards)

    def keys(self):
        for s in self._shards:
            yield from s.keys()
