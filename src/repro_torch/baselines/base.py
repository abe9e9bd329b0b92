"""What the baseline trainers share: their device, their numpy state under
the reference's names, and their evaluation and C3-Score."""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np

from repro_torch.core.accounting import Meter
from repro_torch.core.c3 import c3_score
from repro_torch.weights import device_of, from_numpy, to_numpy


class BaselineTrainer:
    """Base of ``FedTrainer`` and ``SplitTrainer``.  A subclass names its
    state in ``STATE_KEYS`` (or ``_state_keys``) and defines
    ``client_accuracies``."""
    STATE_KEYS: tuple = ()

    def __init__(self, cfg, hp, clients, device):
        self.cfg, self.hp, self.clients = cfg, hp, clients
        self.n = len(clients)
        self.device = device_of(device)
        self.meter = Meter()
        self.history: List[Dict[str, Any]] = []
        # one numpy stream feeds every client's batches in turn
        self._rng = np.random.default_rng(hp.seed)

    def _state_keys(self):
        return self.STATE_KEYS

    def get_state(self) -> dict:
        """Numpy copies of the state, under the reference's names."""
        return to_numpy({k: getattr(self, k) for k in self._state_keys()})

    def set_state(self, state: dict):
        """Adopt a numpy state tree (the reference trainer's, carried
        across through numpy)."""
        st = from_numpy({k: state[k] for k in self._state_keys()},
                        self.device)
        for k, v in st.items():
            setattr(self, k, v)

    def client_accuracies(self) -> np.ndarray:
        raise NotImplementedError

    def evaluate(self) -> float:
        return 100.0 * float(np.mean(self.client_accuracies(),
                                     dtype=np.float64))

    def c3(self, bandwidth_budget, compute_budget, temperature=8.0):
        acc = (self.history[-1].get("accuracy") if self.history else None) \
            or self.evaluate()
        return c3_score(acc, self.meter.bandwidth_gb,
                        self.meter.client_tflops,
                        bandwidth_budget=bandwidth_budget,
                        compute_budget=compute_budget,
                        temperature=temperature)
