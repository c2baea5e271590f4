"""K1's counted bound over its measured device time a launch, in the filter
call, %."""

from portbench.metrics import _common


def read(reading):
    return _common.k1_roofline(reading)
