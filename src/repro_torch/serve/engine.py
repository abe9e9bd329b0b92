"""Personalized serving: request/stats types and the FIFO engine (port
of ``repro.serve.engine``).

The AdaSplit inference story (§3.3) at service level: many clients, one
shared server parameter store, each client served through its own
``M^s * m_i``.  ``ServeEngine`` is a blocking FIFO engine whose
``run_until_idle`` drains the queue in head-of-line batches.  A
single-client batch serves mask-FOLDED server weights (folding paid
once per client, LRU-cached); with ``mixed_batches=True`` a batch may
span clients and is served through per-example GATES (each client's
binarized gate tree, LRU-cached, stacked per example).  Ragged prompts
are RIGHT-padded, and each example's last-token logits and decode
positions are its own (``last_index`` + per-slot ``pos`` through
``models.decode``), so a ragged batch decodes the same tokens as
serving each request alone.  A stack that cannot mask pad state (an
SSM or hybrid one: its mixers fold every token into their state; an
encoder-decoder, whose decoder has no ragged prompt axis) runs a ragged
batch as equal-length sub-batches instead, in the order of their first
request, as the reference's ``_ragged_ok`` fallback does.  An
encoder-decoder's batch is given zero source frame embeddings of
(B, prompt length, D) in bf16, as the reference's engine gives it.
A finished request's row keeps computing until the batch's largest
budget, but each request is billed at its own budget and its latency
is admission -> completion of ITS last token.

Accounting (``EngineStats``): ``tokens`` counts tokens decoded for live
requests (the over-decode past a request's own budget included),
``completed`` the tokens delivered within budgets; ``occupancy`` is the
mean fraction of decode-batch rows doing useful work per step.

Everything runs on ``device`` (default the CUDA card); the prefill's
self-attention goes through the flash-attention kernel there.
"""
from __future__ import annotations

import collections
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import masks as masks_mod
from repro_torch.models import decode as dec
from repro_torch.serve.lru import ShardedLRU


@dataclass
class Request:
    req_id: int
    client_id: int
    prompt: np.ndarray              # (prompt_len,) int32
    max_new_tokens: int = 16
    # filled by the engine:
    output: Optional[np.ndarray] = None
    latency_s: float = 0.0          # admission -> completion of ITS last token
    t_submit: float = 0.0
    t_admit: float = 0.0
    t_done: float = 0.0


@dataclass
class EngineStats:
    requests: int = 0
    tokens: int = 0                 # tokens decoded for live requests (work)
    completed: int = 0              # tokens delivered within request budgets
    batches: int = 0
    decode_steps: int = 0
    slot_steps: int = 0             # sum over steps of useful (in-budget) rows
    slot_capacity: int = 0          # decode batch width
    mixed_batches: int = 0          # batches spanning >1 client
    fold_hits: int = 0
    fold_misses: int = 0
    gate_hits: int = 0
    gate_misses: int = 0
    wall_s: float = 0.0

    @property
    def tokens_per_s(self):
        """Decode WORK rate — includes FIFO over-decode."""
        return self.tokens / max(self.wall_s, 1e-9)

    @property
    def completed_per_s(self):
        """Goodput: tokens delivered within budgets per second."""
        return self.completed / max(self.wall_s, 1e-9)

    @property
    def mean_batch_occupancy(self):
        return self.requests / max(self.batches, 1)

    @property
    def occupancy(self):
        """Mean fraction of decode-batch rows doing useful work."""
        denom = self.decode_steps * max(self.slot_capacity, 1)
        return self.slot_steps / max(denom, 1)


def _sync(t):
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


class ServeEngine:
    """Blocking FIFO engine (the serving ladder's reference rung)."""

    def __init__(self, cfg, params, masks=None, *, max_batch: int = 8,
                 fold_cache_size: int = 4, window: int = 0,
                 binarize_threshold: float = 0.0,
                 mixed_batches: bool = False, device="cuda"):
        self.cfg, self.params, self.masks = cfg, params, masks
        self.device = torch.device(device)
        self.max_batch = max_batch
        self.window = window
        self.binarize_threshold = binarize_threshold
        self.mixed_batches = mixed_batches
        self.queue: collections.deque = collections.deque()
        self.stats = EngineStats(slot_capacity=max_batch)
        # exact (single-shard) LRUs
        self._fold_cache = ShardedLRU(fold_cache_size, n_shards=1)
        # a mixed batch can touch up to max_batch distinct clients
        self._gate_cache = ShardedLRU(max(fold_cache_size, max_batch),
                                      n_shards=1)

    # ------------------------------------------------------------------
    def submit(self, req: Request):
        req.t_submit = req.t_submit or time.time()
        self.queue.append(req)

    def _server_for(self, client_id: int):
        """Mask-folded server weights, LRU-cached per client."""
        if self.masks is None:
            return self.params["server"]
        folded = self._fold_cache.get_or_add(
            client_id,
            lambda: masks_mod.fold_unit_masks(
                self.cfg, self.params["server"], self.masks, client_id,
                threshold=self.binarize_threshold))
        self.stats.fold_hits = self._fold_cache.hits
        self.stats.fold_misses = self._fold_cache.misses
        return folded

    def _gates_for(self, client_id: int):
        """One client's per-unit gate tree (leaves (n_rep, U)),
        binarized per the engine threshold, LRU-cached."""
        def build():
            g = masks_mod.gates_for_client(self.masks, client_id)
            if self.binarize_threshold > 0:
                g = masks_mod.binarize(g, self.binarize_threshold)
            return g
        g = self._gate_cache.get_or_add(client_id, build)
        self.stats.gate_hits = self._gate_cache.hits
        self.stats.gate_misses = self._gate_cache.misses
        return g

    def _next_batch(self) -> List[Request]:
        """Mixed policy: strict FIFO, up to max_batch requests of any
        client.  Client policy: the FIFO head's client, then every queued
        request of that client up to max_batch.  Both keep per-client
        FIFO order."""
        if not self.queue:
            return []
        if self.mixed_batches:
            return [self.queue.popleft()
                    for _ in range(min(self.max_batch, len(self.queue)))]
        head = self.queue[0]
        batch, keep = [], collections.deque()
        while self.queue and len(batch) < self.max_batch:
            r = self.queue.popleft()
            if r.client_id == head.client_id:
                batch.append(r)
            else:
                keep.append(r)
        while keep:
            self.queue.appendleft(keep.pop())
        return batch

    # ------------------------------------------------------------------
    def _step(self, params, cache, tok, pos, gates):
        lg, cache = dec.decode_step(self.cfg, params, tok, cache, pos,
                                    window=self.window, gates=gates)
        return lg.argmax(dim=-1).to(torch.int32), cache

    def _batch_model(self, batch: List[Request]):
        """(params, gates) for the batch: folded weights for a
        single-client batch, per-example gates for a mixed one."""
        clients = [r.client_id for r in batch]
        if self.masks is None:
            return self.params, None
        if len(set(clients)) == 1:
            return {"client": self.params["client"],
                    "server": self._server_for(clients[0])}, None
        gates = masks_mod.stack_client_gates(
            [self._gates_for(c) for c in clients])
        return self.params, gates

    def _run_batch(self, batch: List[Request]):
        cfg = self.cfg
        lens = np.array([len(r.prompt) for r in batch], np.int32)
        if len(set(lens.tolist())) > 1 and not dec.slot_serving_ok(cfg):
            # an SSM or encoder-decoder stack cannot mask pad state:
            # exact equal-length sub-batches (correctness over batching)
            by_len: Dict[int, List[Request]] = {}
            for r in batch:
                by_len.setdefault(len(r.prompt), []).append(r)
            return [r for sub in by_len.values()
                    for r in self._run_batch(sub)]
        t0 = time.time()
        for r in batch:
            r.t_admit = t0
        params, gates = self._batch_model(batch)
        plen = int(lens.max())
        gen = max(r.max_new_tokens for r in batch)
        ragged = bool((lens != plen).any())
        prompts_np = np.zeros((len(batch), plen), np.int32)
        for i, r in enumerate(batch):
            # RIGHT-pad: causal attention never reaches forward into the
            # pad keys, and `last_index` takes each example's logits at
            # ITS last real token
            prompts_np[i, : lens[i]] = r.prompt
        prompts = torch.from_numpy(prompts_np).to(self.device)
        lens_dev = torch.from_numpy(lens).to(self.device)
        last_index = lens_dev - 1 if ragged else None
        extras = None
        if cfg.is_encoder_decoder:
            extras = {"src_embeds": torch.zeros(
                (len(batch), plen, cfg.d_model), dtype=torch.bfloat16,
                device=self.device)}
        logits, cache = dec.prefill(cfg, params, prompts, extras,
                                    window=self.window, gates=gates,
                                    cache_len=plen + gen + 1,
                                    last_index=last_index)
        tok = logits.argmax(dim=-1).to(torch.int32)
        outs = [tok]

        # per-request stop: request r has its r.max_new_tokens tokens
        # after decode step r.max_new_tokens - 2 (prefill produced the
        # first); its completion time is recorded there, while the batch
        # runs on to the largest budget (billed as work only)
        due: Dict[int, List[Request]] = {}
        for r in batch:
            due.setdefault(r.max_new_tokens - 2, []).append(r)

        def finish(step_idx, t):
            _sync(t)
            tdone = time.time()
            for r in due.get(step_idx, []):
                r.t_done = tdone
                r.latency_s = tdone - r.t_admit

        finish(-1, tok)
        for t in range(gen - 1):
            pos = lens_dev + t if ragged else plen + t
            tok, cache = self._step(params, cache, tok, pos, gates)
            outs.append(tok)
            if t in due:
                finish(t, tok)
        out = torch.cat(outs, dim=1).cpu().numpy()
        dt = time.time() - t0
        for i, r in enumerate(batch):
            r.output = out[i, : r.max_new_tokens]
        self.stats.requests += len(batch)
        self.stats.tokens += len(batch) * gen
        self.stats.completed += int(sum(r.max_new_tokens for r in batch))
        self.stats.batches += 1
        self.stats.decode_steps += gen - 1
        self.stats.slot_steps += int(
            sum(min(r.max_new_tokens, gen) - 1 for r in batch))
        if len({r.client_id for r in batch}) > 1:
            self.stats.mixed_batches += 1
        self.stats.wall_s += dt
        return batch

    def run_until_idle(self) -> List[Request]:
        done: List[Request] = []
        while self.queue:
            done.extend(self._run_batch(self._next_batch()))
        return done
