"""Device time of one resampling step (span `aesmc.smc.resample`: the
CDF, the search and gather and the step's log-Z term) in the eager filter
call, us."""

from portbench.metrics import _common


def read(reading):
    return _common.span_device_us(reading, "aesmc.smc.resample")
