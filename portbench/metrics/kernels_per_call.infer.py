"""Device operations (kernels, copies, fills) an infer call, from the
profiler."""

from portbench.metrics import _common


def read(reading):
    return _common.device_ops_per_item(reading)
