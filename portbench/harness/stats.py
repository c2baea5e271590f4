"""The arithmetic of the end-to-end metrics: a window's mean time, a
percentile over every sample, and the spread the bounds come from."""

from __future__ import annotations

import math
import statistics


def per_item_ms(window_s: float, items: int) -> float:
    """Milliseconds an item over a whole window: all its time over all the
    items completed in it."""
    if items <= 0:
        raise ValueError("no item completed in the window")
    return window_s * 1e3 / items


def percentile(samples, q: float) -> float:
    """The ``q``-th percentile (0 < q <= 100) of every sample, by nearest
    rank: the smallest sample with at least q% of the samples at or below
    it."""
    values = sorted(samples)
    if not values:
        raise ValueError("no samples")
    rank = max(1, math.ceil(q / 100 * len(values)))
    return values[rank - 1]


def spread(values) -> float:
    """The distance between the first and the third quartile as a share of
    the median, the quartiles as `statistics.quantiles(values, n=4)`
    gives them."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2
