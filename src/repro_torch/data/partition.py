"""Generic client partitioners (Dirichlet label skew — the standard
non-IID FL benchmark protocol); a numpy copy of
``repro.data.partition``."""
from __future__ import annotations

from typing import List

import numpy as np


def dirichlet_partition(y: np.ndarray, n_clients: int, alpha: float = 0.5,
                        seed: int = 0, min_size: int = 2) -> List[np.ndarray]:
    """Returns per-client index arrays with Dirichlet(alpha) label skew."""
    rng = np.random.default_rng(seed)
    n_classes = int(y.max()) + 1
    while True:
        parts = [[] for _ in range(n_clients)]
        for c in range(n_classes):
            idx = np.where(y == c)[0]
            rng.shuffle(idx)
            props = rng.dirichlet([alpha] * n_clients)
            cuts = (np.cumsum(props) * len(idx)).astype(int)[:-1]
            for i, chunk in enumerate(np.split(idx, cuts)):
                parts[i].extend(chunk.tolist())
        if min(len(p) for p in parts) >= min_size:
            return [np.asarray(sorted(p)) for p in parts]
