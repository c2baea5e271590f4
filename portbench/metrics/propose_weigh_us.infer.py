"""Device time of the model algebra a time step (spans `aesmc.smc.propose`
and `aesmc.smc.weigh`, over the steps that propose) in the eager filter
call, us."""

from portbench.metrics import _common


def read(reading):
    return _common.span_device_us(reading, *_common.PROPOSE_WEIGH)
