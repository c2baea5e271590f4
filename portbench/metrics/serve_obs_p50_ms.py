"""Median latency of the served observations in the traced window, ms."""

from portbench.metrics import _common


def read(reading):
    return _common.latency_p50_ms(reading)
