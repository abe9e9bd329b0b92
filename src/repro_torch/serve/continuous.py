"""Continuous-batching personalized serving (port of
``repro.serve.continuous``).

One persistent decode batch of ``max_batch`` slots.  A request's life:

  submit -> FIFO queue -> ADMIT into a free slot (its prompt prefills
  alone, right-padded to a power-of-two length bucket, and its B=1
  cache is copied into the slot's row of the persistent batch cache)
  -> it rides the shared decode step, at ITS OWN cache position, until
  ITS OWN ``max_new_tokens`` -> the slot frees and the next queued
  request prefills into it MID-FLIGHT.

Ragged lengths are the steady state, and correctness comes from
per-slot state rather than batch-wide padding:

* each slot feeds the decode step its own position, writes K/V at its
  own cache row offset, and attends only to ``idx <= pos[slot]``
  (``models.attention.attn_decode``'s per-slot path);
* admission prefill right-pads to the bucket and passes ``last_index``
  (``models.decode.prefill``), so the slot joins with exactly the cache
  it would have alone; on the card its self-attention is the flash
  kernel at B=1;
* per-client personalization is a per-slot GATE column (leaves
  (n_rep, B, U), ``masks.init_slot_gates`` / ``set_slot_gates``)
  written at admission; client gate trees come from a sharded LRU
  (``serve.lru.ShardedLRU``) sized to the in-flight working set.

Per-slot state lives in persistent device tensors: the fed token, the
cache position, the output column, an active flag, the output buffer,
the slot gates and the KV cache.  An admission writes one slot's
entries with device copies and fill kernels; a decode step reads them
and advances the active rows with device ops, so a steady-state step
(no admission, no completion) makes no host sync, and its inputs are
fixed buffers.  The engine syncs the host in two places only, each
counted in ``host_syncs``: the upload of an admitted prompt and the
read of a finished request's row.  Free slots park at position 0 and
output column ``cache_len - 1``; their rows compute and are never read.

Scheduling is host-side and pure (``serve.scheduler.SlotScheduler``).
Limits: decoder-only attention stacks (``dec.slot_serving_ok``), no
sliding window (each slot owns a full-length cache row), greedy
decode.  The FIFO ``ServeEngine`` remains the differential oracle.
"""
from __future__ import annotations

import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core import masks as masks_mod
from repro_torch.models import decode as dec
from repro_torch.serve.engine import EngineStats, Request
from repro_torch.serve.lru import ShardedLRU
from repro_torch.serve.scheduler import SlotScheduler


def _bucket(n: int, cap: int) -> int:
    b = 8
    while b < n:
        b *= 2
    return min(b, cap)


class ContinuousEngine:
    def __init__(self, cfg, params, masks=None, *, max_batch: int = 8,
                 cache_len: int = 128, gate_cache_size: Optional[int] = None,
                 gate_shards: int = 4, binarize_threshold: float = 0.0,
                 device="cuda"):
        if not dec.slot_serving_ok(cfg):
            raise ValueError(
                "ContinuousEngine needs a decoder-only attention arch "
                f"(got {cfg.name}); use ServeEngine")
        self.cfg, self.params, self.masks = cfg, params, masks
        self.device = torch.device(device)
        self.max_batch = max_batch
        self.cache_len = cache_len
        self.binarize_threshold = binarize_threshold
        self.sched = SlotScheduler(max_batch)
        self.stats = EngineStats(slot_capacity=max_batch)
        self.host_syncs = {"prompt_uploads": 0, "row_reads": 0}
        self._done: List[Request] = []
        if masks is not None:
            # properly sized: every in-flight slot's client plus rotation
            # headroom must fit, or steady traffic thrashes the cache
            cap = gate_cache_size or max(4 * max_batch, 16)
            if cap < max_batch:
                raise ValueError(
                    f"gate_cache_size {cap} < max_batch {max_batch}: "
                    "in-flight clients would evict each other")
            self._gate_lru = ShardedLRU(cap, n_shards=gate_shards)
        else:
            self._gate_lru = None
        self._cache = None      # device state, allocated at the first step

    def _alloc(self):
        B, L, dev = self.max_batch, self.cache_len, self.device
        self._cache = dec.init_cache(self.cfg, B, L, device=dev)
        self._tok = torch.zeros((B, 1), dtype=torch.int32, device=dev)
        self._pos = torch.zeros((B,), dtype=torch.long, device=dev)
        self._gen = torch.full((B,), L - 1, dtype=torch.long, device=dev)
        self._active = torch.zeros((B,), dtype=torch.long, device=dev)
        self._outbuf = torch.zeros((B, L), dtype=torch.int32, device=dev)
        self._gates = masks_mod.init_slot_gates(self.masks, B) \
            if self.masks is not None else None

    # ------------------------------------------------------------------
    # device ops
    # ------------------------------------------------------------------
    def _decode(self):
        """One decode step of every slot, in place on the slot state."""
        lg, _ = dec.decode_step(self.cfg, self.params, self._tok,
                                self._cache, self._pos, gates=self._gates)
        self._tok.copy_(lg.argmax(dim=-1))
        self._outbuf.scatter_(1, self._gen[:, None], self._tok)
        self._pos += self._active
        self._gen += self._active

    def _upload(self, prompt: np.ndarray):
        """The admitted prompt to the device: a host sync on the card."""
        self.host_syncs["prompt_uploads"] += 1
        return torch.from_numpy(prompt).to(self.device)

    def _read_row(self, slot: int, n: int) -> np.ndarray:
        """A finished row's tokens to the host: a host sync on the card,
        which also waits for the step that completed it.  A copy on
        every device: the slot's next occupant overwrites the row."""
        self.host_syncs["row_reads"] += 1
        return self._outbuf[slot, :n].to("cpu", copy=True).numpy()

    # ------------------------------------------------------------------
    def _gates_for(self, client_id: int):
        def build():
            g = masks_mod.gates_for_client(self.masks, client_id)
            if self.binarize_threshold > 0:
                g = masks_mod.binarize(g, self.binarize_threshold)
            return g
        g = self._gate_lru.get_or_add(client_id, build)
        self.stats.gate_hits = self._gate_lru.hits
        self.stats.gate_misses = self._gate_lru.misses
        return g

    def submit(self, req: Request):
        L, budget = len(req.prompt), req.max_new_tokens
        if budget < 1:
            raise ValueError(f"request {req.req_id}: max_new_tokens < 1")
        if L + budget > self.cache_len:
            raise ValueError(
                f"request {req.req_id}: prompt {L} + budget {budget} "
                f"exceeds cache_len {self.cache_len}")
        req.t_submit = req.t_submit or time.time()
        self.sched.submit(req)

    # ------------------------------------------------------------------
    def _do_admit(self, slot: int, req: Request, now: float):
        L = len(req.prompt)
        b = _bucket(L, self.cache_len)
        prompt = np.zeros((1, b), np.int32)
        prompt[0, :L] = req.prompt
        gates_c = self._gates_for(req.client_id) \
            if self.masks is not None else None
        last = torch.full((1,), L - 1, dtype=torch.int32, device=self.device)
        lg, one_cache = dec.prefill(self.cfg, self.params,
                                    self._upload(prompt), gates=gates_c,
                                    cache_len=self.cache_len,
                                    last_index=last)
        first = lg.argmax(dim=-1)                           # (1, 1)
        dec.merge_slot_cache(self._cache, one_cache, slot)
        self._tok[slot].copy_(first[0])
        self._outbuf[slot, 0].copy_(first[0, 0])
        if self._gates is not None:
            masks_mod.set_slot_gates(self._gates, slot, gates_c)
        # fill_ launches a kernel; `t[slot] = x` would upload x and sync
        self._pos[slot].fill_(L)
        self._gen[slot].fill_(1)
        self._active[slot].fill_(int(req.max_new_tokens > 1))
        req.t_admit = now
        self.stats.tokens += 1          # prefill produced its first token

    def _finish(self, slot: int, req: Request):
        req.output = self._read_row(slot, req.max_new_tokens)
        req.t_done = time.time()
        req.latency_s = req.t_done - req.t_admit
        self.stats.requests += 1
        self.stats.completed += req.max_new_tokens
        self._done.append(req)
        # the free slot parks at position 0 / the last output column
        self._pos[slot].fill_(0)
        self._gen[slot].fill_(self.cache_len - 1)
        self._active[slot].fill_(0)

    def step(self) -> bool:
        """Admit into free slots, then one decode step for the whole
        batch.  Returns False when there is nothing in flight (caller
        may sleep / feed more traffic)."""
        if self._cache is None:
            self._alloc()
        progress = False
        while True:     # admission chains: a budget-1 request frees its
            now = time.time()            # slot before any decode step
            admitted = self.sched.admit()
            for slot, req in admitted:
                self._do_admit(slot, req, now)
            completed = self.sched.pop_completed()
            for slot, req in completed:
                self._finish(slot, req)
            progress = progress or bool(admitted or completed)
            if not admitted and not completed:
                break

        if not self.sched.active():
            return progress
        self._decode()
        n = self.sched.note_step()
        self.stats.decode_steps += 1
        self.stats.slot_steps += n
        self.stats.tokens += n
        for slot, req in self.sched.pop_completed():
            self._finish(slot, req)
        return True

    def run_until_idle(self) -> List[Request]:
        """Drain the queue; returns requests in completion order."""
        t0 = time.time()
        self._done = []
        while not self.sched.idle():
            self.step()
        self.stats.wall_s += time.time() - t0
        return self._done
