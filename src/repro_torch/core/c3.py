"""C3-Score (AdaSplit eq. 9): accuracy under bandwidth+compute budgets.

C3 = (A/Amax) * exp(-(B/Bmax + C/Cmax) / T)

T defaults to 8.0 — back-solved from the paper's own tables (e.g. Table 1
SL-basic 0.72, AdaSplit 0.85; Table 2 SL-basic 0.59 fits with the
dataset's budgets), giving the closest simultaneous match to all
published scores.
"""
from __future__ import annotations

import math


def c3_score(accuracy: float, bandwidth: float, compute: float, *,
             bandwidth_budget: float, compute_budget: float,
             temperature: float = 8.0, a_max: float = 100.0) -> float:
    if bandwidth_budget <= 0 or compute_budget <= 0:
        raise ValueError("budgets must be positive")
    a_hat = accuracy / a_max
    b_hat = bandwidth / bandwidth_budget
    c_hat = compute / compute_budget
    return a_hat * math.exp(-(b_hat + c_hat) / temperature)
