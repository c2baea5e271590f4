"""The timed window of a run, and what the profiler saw in it.

A driver calls `Window.open()` when its timed work starts and
`Window.close()` when the device has finished it. In a traced run
(``--trace 1``) torch.profiler (CPU and CUDA activity) covers the window,
which is also marked as one host range, and `summarize` reduces the
profiler's events to a `TraceSummary`: the device's busy time inside the
window (the union of every kernel, copy and fill), the device operations
by name, and the idle gaps named by what the host was doing at the time.

`spans` reads a stopped profiler by span: for each host range named
``aesmc.*`` (the program's spans, `profiling.annotate`) or
``portbench.*`` (the harness's own), how often it occurred and the device
work launched while it was open.
"""

from __future__ import annotations

import heapq
import re
import time
from collections import defaultdict
from dataclasses import dataclass, field

# Idle host time between the profiler's start and the window's work: a
# window whose work is launched the moment the profiler starts has now
# and then come back with no device event at all.
PROFILE_MARGIN_S = 0.02
WINDOW_RANGE = "portbench.window"
# The host ranges `spans` reads: the program's spans and the harness's.
SPAN_PREFIXES = ("aesmc.", "portbench.")
# A CUDA runtime or driver API call's name, as the profiler gives it.
CUDA_API = re.compile(r"cu(da)?[A-Z]")


class Window:
    """The timed part of one run, on the host's clock."""

    def __init__(self, traced: bool = False, device=None):
        self.traced = traced
        self.device = device
        self.start = self.end = None
        self.profiler = None
        self._range = None

    def _sync(self):
        import torch
        if self.device is not None and torch.device(self.device).type == \
                "cuda":
            torch.cuda.synchronize(self.device)

    def open(self) -> None:
        self._sync()
        if self.traced:
            import torch
            from torch.autograd.profiler import record_function
            from torch.profiler import ProfilerActivity, profile
            activities = [ProfilerActivity.CPU]
            if self.device is not None and \
                    torch.device(self.device).type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            self.profiler = profile(activities=activities)
            self.profiler.start()
            time.sleep(PROFILE_MARGIN_S)
            self._range = record_function(WINDOW_RANGE)
            self._range.__enter__()
        self.start = time.perf_counter()

    def close(self) -> None:
        self._sync()
        self.end = time.perf_counter()
        if self.traced:
            self._range.__exit__(None, None, None)
            self.profiler.stop()

    @property
    def seconds(self) -> float:
        return self.end - self.start


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    device_events: int
    # name -> [count, seconds] of every device operation in the window.
    ops: dict = field(default_factory=dict)
    # what the host was doing -> idle seconds of the device.
    idle_by_host: dict = field(default_factory=dict)

    def kernel(self, fragment: str):
        """(launches, seconds) of the device operations whose name holds
        ``fragment``."""
        count = seconds = 0
        for name, (n, s) in self.ops.items():
            if fragment in name:
                count += n
                seconds += s
        return count, seconds

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.ops.items(), key=lambda kv: -kv[1][1])[:top]
        idle = sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, s] for n, (_, s) in ops],
                "idle_gaps": [[n, s] for n, s in idle]}


def _raw_events(profiler):
    """(name, is_device, start_ns, end_ns) of every event."""
    from torch.autograd import DeviceType
    out = []
    for e in profiler.profiler.kineto_results.events():
        on_device = e.device_type() == DeviceType.CUDA
        if on_device and e.is_user_annotation():
            continue
        start = e.start_ns()
        out.append((e.name(), on_device, start, start + e.duration_ns()))
    return out


def summarize(profiler, events=None) -> TraceSummary:
    """The window's `TraceSummary` from a stopped profiler (or from
    ``events``, tuples (name, is_device, start_ns, end_ns))."""
    events = _raw_events(profiler) if events is None else events
    marks = [e for e in events if not e[1] and e[0] == WINDOW_RANGE]
    if not marks:
        raise RuntimeError("the profiler holds no window range")
    lo, hi = marks[0][2], marks[0][3]
    device = sorted((s, e, n) for n, d, s, e in events
                    if d and e > lo and s < hi)
    host = sorted((s, e, n) for n, d, s, e in events
                  if not d and n != WINDOW_RANGE and e > lo and s < hi)
    ops = defaultdict(lambda: [0, 0.0])
    busy = 0
    gaps = []
    cursor = lo
    for s, e, n in device:
        s, e = max(s, lo), min(e, hi)
        op = ops[n]
        op[0] += 1
        op[1] += (e - s) * 1e-9
        if s > cursor:
            gaps.append((cursor, s))
        if e > cursor:
            busy += e - max(s, cursor)
            cursor = e
    if hi > cursor:
        gaps.append((cursor, hi))
    return TraceSummary(window_s=(hi - lo) * 1e-9, busy_s=busy * 1e-9,
                        device_events=len(device), ops=dict(ops),
                        idle_by_host=_name_gaps(gaps, host))


def _name_gaps(gaps, host) -> dict:
    """Idle seconds by the innermost host operation running at each gap's
    midpoint ('host: no operation' where none was)."""
    named = defaultdict(float)
    by_end, by_start = [], []          # heaps of active host events
    i = 0
    for lo, hi in sorted(gaps):
        mid = (lo + hi) // 2
        while i < len(host) and host[i][0] <= mid:
            s, e, n = host[i]
            heapq.heappush(by_end, (e, i))
            heapq.heappush(by_start, (-s, i, n))
            i += 1
        while by_end and by_end[0][0] < mid:
            heapq.heappop(by_end)
        live = {j for _, j in by_end}
        while by_start and by_start[0][1] not in live:
            heapq.heappop(by_start)
        name = by_start[0][2] if by_start else "host: no operation"
        named[name] += (hi - lo) * 1e-9
    return dict(named)


def _span_events(profiler):
    """(ranges, calls, device) of a stopped profiler: the host ranges
    (name, thread, start_ns, end_ns) named by `SPAN_PREFIXES`, the CUDA
    runtime and driver calls (thread, start_ns, correlation) and the
    device operations (correlation, start_ns, end_ns). The profiler gives
    a call and the ranges around it one thread id. A call that was made
    inside an op links to it; one made in no op (a launch from a library
    of the program's own, straight inside a span) is known by its API
    name alone."""
    from torch.autograd import DeviceType
    ranges, calls, device = [], [], []
    for e in profiler.profiler.kineto_results.events():
        name, start = e.name(), e.start_ns()
        end = start + e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                device.append((e.correlation_id(), start, end))
        elif e.linked_correlation_id() > 0 or CUDA_API.match(name):
            calls.append((e.start_thread_id(), start, e.correlation_id()))
        elif name.startswith(SPAN_PREFIXES):
            ranges.append((name, e.start_thread_id(), start, end))
    return ranges, calls, device


def spans(profiler, events=None) -> dict:
    """{name: {'occurrences', 'launches', 'seconds'}} of every host range
    whose name starts with one of `SPAN_PREFIXES`, from a stopped
    profiler (or from ``events``, as `_span_events` gives them).

    Each device operation is matched to its runtime call by correlation
    id, and counts toward every such range open on the call's thread when
    the call started: the time is inclusive, so a range holds its nested
    ranges' work. 'launches' counts the device operations, 'seconds' sums
    their durations; 'occurrences' counts the host ranges of the name."""
    ranges, calls, device = _span_events(profiler) if events is None \
        else events
    work = defaultdict(lambda: [0, 0])          # correlation -> [ops, ns]
    for correlation, start, end in device:
        work[correlation][0] += 1
        work[correlation][1] += end - start
    # thread -> (time, order, what): at one time a range's end comes
    # before a range's start, and both before a call.
    points = defaultdict(list)
    found = {}
    for name, thread, start, end in ranges:
        found.setdefault(name, {"occurrences": 0, "launches": 0,
                                "seconds": 0.0})["occurrences"] += 1
        points[thread] += [(start, 1, name), (end, 0, name)]
    placed = set()
    for thread, start, correlation in sorted(calls, key=lambda c: c[1]):
        # The first call of a correlation holds its work (a runtime call
        # and the driver call inside it may share one).
        if correlation in work and correlation not in placed:
            placed.add(correlation)
            points[thread].append((start, 2, correlation))
    for line in points.values():
        open_names = defaultdict(int)
        for _, order, what in sorted(line, key=lambda p: p[:2]):
            if order < 2:
                open_names[what] += 1 if order else -1
                continue
            launches, ns = work[what]
            for name, depth in open_names.items():
                if depth > 0:
                    found[name]["launches"] += launches
                    found[name]["seconds"] += ns * 1e-9
    return found
