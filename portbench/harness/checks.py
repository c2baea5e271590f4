"""The numbers that decide `correct`, each against its limit.

Every gap is a number that grows as the program departs from the
reference; a check passes when its number is finite and at most its
limit (an exact comparison has the limit 0).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np


@dataclass
class Check:
    name: str
    value: float
    limit: float

    @property
    def passed(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


def checks(values: dict, limits: dict) -> list:
    """One `Check` for each limit, with the number of the same name (NaN,
    which fails, where none was worked out)."""
    return [Check(name, float(values.get(name, math.nan)), float(limit))
            for name, limit in limits.items()]


def correct(found: list) -> bool:
    """A run is correct when it has checks and every one passes."""
    return bool(found) and all(c.passed for c in found)


def widest_gap(estimates, exact) -> float:
    """The largest |estimate - exact| over every element (inf for a
    non-finite estimate)."""
    gap = np.abs(np.asarray(estimates, np.float64) -
                 np.asarray(exact, np.float64))
    return float(np.max(np.where(np.isfinite(gap), gap, np.inf)))


def sample(count: int, size: int, seed: int) -> np.ndarray:
    """Up to ``size`` distinct indices of ``count`` items, drawn from
    ``seed``, sorted; the last item is always among them."""
    rng = np.random.default_rng(seed)
    if count <= size:
        return np.arange(count)
    picked = rng.choice(count - 1, size=size - 1, replace=False)
    return np.sort(np.append(picked, count - 1))
