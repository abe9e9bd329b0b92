"""Synthetic LM token pipeline for the transformer architectures (a
copy of ``repro.data.tokens``: numpy only, the same draws from the same
seed).

Each client is a *domain*: a client-specific bigram transition matrix
over the vocab (sparse, row-normalised).  Sequences are Markov samples;
``seq_label`` (= the domain id) supplies the positive-pair labels for the
client-side NT-Xent loss.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np


@dataclass
class LMClientDataset:
    client_id: int
    vocab_size: int
    seq_len: int
    _rng: np.random.Generator = None
    _next_tok: np.ndarray = None  # (V, branching) candidate successors

    def sample(self, batch: int) -> Dict[str, np.ndarray]:
        V, S = self.vocab_size, self.seq_len
        toks = np.empty((batch, S + 1), np.int32)
        toks[:, 0] = self._rng.integers(0, V, batch)
        branch = self._next_tok.shape[1]
        choice = self._rng.integers(0, branch, (batch, S))
        for t in range(S):
            toks[:, t + 1] = self._next_tok[toks[:, t], choice[:, t]]
        return {
            "tokens": toks[:, :-1],
            "targets": toks[:, 1:],
            "seq_labels": np.full((batch,), self.client_id, np.int32),
        }


def lm_client_dataset(client_id: int, vocab_size: int, seq_len: int,
                      seed: int = 0, branching: int = 4) -> LMClientDataset:
    rng = np.random.default_rng(seed + 7919 * (client_id + 1))
    nxt = rng.integers(0, vocab_size, (vocab_size, branching)).astype(np.int32)
    return LMClientDataset(client_id, vocab_size, seq_len, rng, nxt)


def lm_batch_iterator(datasets, batch_per_client: int
                      ) -> Iterator[Dict[str, np.ndarray]]:
    """Infinite iterator over stacked per-client batches.

    Yields dict with tokens (C*b, S), targets, seq_labels, client_ids.
    """
    while True:
        parts = [d.sample(batch_per_client) for d in datasets]
        out = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
        out["client_ids"] = np.repeat(
            np.arange(len(datasets), dtype=np.int32), batch_per_client)
        yield out
