"""What the per-layer readers share. Each returns None where its cell's
traced window holds nothing to read (no launch of its kernel, no item)."""

from __future__ import annotations

from portbench.counts import kernels, peaks
from portbench.harness import stats

K1 = "resample_systematic_kernel"
# The profiler's own work (CUPTI's buffers), during which the device can
# stall: its idle time is the profiler's, not the program's.
PROFILER = ("Buffer Flush", "Activity Buffer Request", "Command Buffer Full")
# The model algebra of a time step.
PROPOSE_WEIGH = ("aesmc.smc.propose", "aesmc.smc.weigh")


def _per_launch(reading, kernel):
    launches, seconds = reading.summary.kernel(kernel)
    return seconds / launches if launches else None


def k1_roofline(reading):
    """K1's counted bound a launch over its measured device time, %."""
    measured = _per_launch(reading, K1)
    if measured is None:
        return None
    counts, ctx = reading.counts, reading.ctx
    nbytes = kernels.k1_bytes(*counts.k1_shape(ctx.traffic, ctx.config))
    return 100.0 * peaks.least_seconds(0, nbytes) / measured


def per_item(reading, value):
    items = reading.records.get("items", 0)
    return value / items if items else None


def device_ops_per_item(reading):
    return per_item(reading, reading.summary.device_events)


def idle_share(reading):
    """The device's idle share of the traced window, the time the
    profiler's own buffer work held it idle taken out of both."""
    s = reading.summary
    stalled = sum(s.idle_by_host.get(name, 0.0) for name in PROFILER)
    window = s.window_s - stalled
    if window <= 0:
        return None
    return 100.0 * (window - s.busy_s) / window


def step_mfu(reading, work):
    """The item's least time on one card (counted operations over the
    float32 peak, counted bytes over HBM, the larger) over its measured
    time, taken in the same run without the profiler, %."""
    item_s = reading.records.get("item_s")
    if not item_s:
        return None
    ctx = reading.ctx
    ops, nbytes = getattr(reading.counts, work)(ctx.traffic, ctx.config)
    return 100.0 * peaks.least_seconds(ops, nbytes) / item_s


def latency_p50_ms(reading):
    latencies = reading.records.get("latencies_s")
    return stats.percentile(latencies, 50) * 1e3 if latencies else None


def _under_spans(reading, names):
    """(device launches, device seconds) under the spans ``names``, and
    the occurrences of the first, from the driver's `spans` record
    (`trace.spans`); None where no device operation ran under them."""
    spans = reading.records.get("spans") or {}
    occurrences = spans.get(names[0], {}).get("occurrences", 0)
    launches = sum(spans[n]["launches"] for n in names if n in spans)
    if not occurrences or not launches:
        return None
    return launches, sum(spans[n]["seconds"] for n in names if n in spans), \
        occurrences


def span_device_us(reading, *names):
    """Device microseconds under the spans ``names`` per occurrence of the
    first."""
    found = _under_spans(reading, names)
    return None if found is None else found[1] * 1e6 / found[2]


def span_launches(reading, *names):
    """Device operations launched under the spans ``names`` per occurrence
    of the first."""
    found = _under_spans(reading, names)
    return None if found is None else found[0] / found[2]
