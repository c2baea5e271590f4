"""Bytes of the port's kernels at a launch's shape (float32 values, the
CDF and positions float32, no index output)."""

from __future__ import annotations

F32 = 4


def k1_bytes(batch: int, k: int, d: int) -> int:
    """K1, fused systematic resample and gather: reads the `[B, K]` CDF,
    one uniform a row and the `[B, K, D]` values; writes the `[B, K, D]`
    resampled values."""
    return F32 * (batch * k + batch + 2 * batch * k * d)
