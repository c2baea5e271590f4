"""Device time of one build of the resampling CDF (span
`aesmc.resample.cdf`) in the eager filter call, us."""

from portbench.metrics import _common


def read(reading):
    return _common.span_device_us(reading, "aesmc.resample.cdf")
