"""A filter call's least time on one H100 over its measured time, %."""

from portbench.metrics import _common


def read(reading):
    return _common.step_mfu(reading, "infer_call")
