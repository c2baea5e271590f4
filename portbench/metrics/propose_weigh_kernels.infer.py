"""Device operations launched by the model algebra a time step (spans
`aesmc.smc.propose` and `aesmc.smc.weigh`, over the steps that propose)
in the eager filter call."""

from portbench.metrics import _common


def read(reading):
    return _common.span_launches(reading, *_common.PROPOSE_WEIGH)
