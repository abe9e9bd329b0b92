"""Host-side slot scheduler for the continuous-batching engine (a copy
of ``repro.serve.scheduler``, which imports nothing of JAX).

Pure Python, no torch: the device work (prefill, cache merge, decode
step) lives in ``serve.continuous``; everything schedulable — the FIFO
queue, slot occupancy, per-slot generated-token counters and per-slot
positions — lives here so the admission policy is property-testable
without running a model.

Invariants (held against the reference scheduler by
tests/test_torch_continuous.py):
* admission is strict global FIFO, hence per-client FIFO;
* a slot holds at most one request, and is only re-admitted into after
  its occupant completed;
* a request steps exactly ``max_new_tokens - 1`` decode steps (its
  first token comes out of its own prefill) and completes at ITS
  budget, never the batch max.
"""
from __future__ import annotations

import collections
from dataclasses import dataclass
from typing import Any, List, Optional, Tuple


@dataclass
class Slot:
    req: Any                 # serve.engine.Request
    prompt_len: int
    gen: int = 1             # tokens produced so far (prefill -> 1)

    @property
    def pos(self) -> int:
        """Cache position of the NEXT decode write = position of the
        token being fed (the last one generated)."""
        return self.prompt_len + self.gen - 1

    @property
    def done(self) -> bool:
        return self.gen >= self.req.max_new_tokens


class SlotScheduler:
    def __init__(self, n_slots: int):
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        self.n_slots = n_slots
        self.queue: "collections.deque" = collections.deque()
        self.slots: List[Optional[Slot]] = [None] * n_slots
        self.admission_log: List[int] = []      # req_ids, admission order

    # ------------------------------------------------------------------
    def submit(self, req) -> None:
        self.queue.append(req)

    def admit(self) -> List[Tuple[int, Any]]:
        """Fill every free slot from the FIFO head.  Returns the
        (slot, request) assignments made (device prefill+merge follows
        per assignment)."""
        out = []
        for i in range(self.n_slots):
            if not self.queue:
                break
            if self.slots[i] is None:
                req = self.queue.popleft()
                self.slots[i] = Slot(req, len(req.prompt))
                self.admission_log.append(req.req_id)
                out.append((i, req))
        return out

    # ------------------------------------------------------------------
    def active(self) -> List[int]:
        """Slots with an in-flight (not yet complete) request."""
        return [i for i, s in enumerate(self.slots)
                if s is not None and not s.done]

    def note_step(self) -> int:
        """Account one decode step: every active slot produced a token.
        Returns the number of active slots stepped."""
        act = self.active()
        for i in act:
            self.slots[i].gen += 1
        return len(act)

    def pop_completed(self) -> List[Tuple[int, Any]]:
        """Free every slot whose occupant hit ITS OWN budget; returns
        the (slot, request) pairs in slot order."""
        out = []
        for i, s in enumerate(self.slots):
            if s is not None and s.done:
                out.append((i, s.req))
                self.slots[i] = None
        return out

    def idle(self) -> bool:
        return not self.queue and all(s is None for s in self.slots)
