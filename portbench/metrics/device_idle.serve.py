"""Share of the traced window with no kernel, copy or fill on the card,
served observations, %."""

from portbench.metrics import _common


def read(reading):
    return _common.idle_share(reading)
