"""`trace.spans` on synthetic profiler events: nested spans with inclusive
time, two host threads, and device work matched to its runtime call by
correlation id."""

import pytest

from portbench.harness import trace

# Host ranges (name, thread, start_ns, end_ns) on threads 1 and 2.
RANGES = [
    ("aesmc.outer", 1, 0, 100),
    ("aesmc.inner", 1, 10, 50),
    ("aesmc.inner", 1, 60, 70),
    ("aesmc.other", 2, 0, 100),
    ("portbench.window", 1, 0, 200),
]
# Runtime calls (thread, start_ns, correlation).
CALLS = [
    (1, 22, 101),       # outer, inner, the window
    (1, 80, 102),       # in outer, after inner: outer, the window
    (2, 27, 103),       # thread 2, while thread 1's inner is open
    (1, 65, 104),       # the second inner
    (1, 66, 104),       # a second call of one correlation: not again
    (1, 150, 105),      # the window alone
    (1, 90, 106),       # a call with no device work
]
# (correlation, start_ns, end_ns); 101 launched two operations (a graph's
# nodes share their launch's correlation); 999 matches no call.
DEVICE = [
    (101, 40, 45), (101, 46, 49),
    (102, 85, 92),
    (103, 30, 41),
    (104, 100, 102),
    (105, 160, 163),
    (999, 170, 190),
]


@pytest.fixture(scope="module")
def found():
    return trace.spans(None, events=(RANGES, CALLS, DEVICE))


@pytest.mark.parametrize("name,occurrences,launches,ns", [
    ("aesmc.outer", 1, 3 + 1, 5 + 3 + 7 + 2),
    ("aesmc.inner", 2, 2 + 1, 5 + 3 + 2),
    ("aesmc.other", 1, 1, 11),
    ("portbench.window", 1, 5, 5 + 3 + 7 + 2 + 3),
])
def test_spans_are_inclusive_per_thread(found, name, occurrences, launches,
                                        ns):
    assert found[name]["occurrences"] == occurrences
    assert found[name]["launches"] == launches
    assert found[name]["seconds"] == pytest.approx(ns * 1e-9)


def test_unmatched_work_counts_nowhere(found):
    # 999's 20 ns went to no span.
    assert max(s["seconds"] for s in found.values()) < 25e-9


def test_call_at_a_span_edge():
    # A call at a span's start is inside it; one at its end is not.
    ranges = [("aesmc.a", 1, 10, 20), ("aesmc.b", 1, 20, 30)]
    calls = [(1, 10, 1), (1, 20, 2)]
    device = [(1, 0, 1), (2, 0, 2)]
    found = trace.spans(None, events=(ranges, calls, device))
    assert (found["aesmc.a"]["launches"], found["aesmc.b"]["launches"]) == \
        (1, 1)


class _Event:
    """The part of a profiler event that `trace._span_events` reads."""

    def __init__(self, name, device, start, duration, correlation,
                 linked=0, thread=1, annotation=False):
        from torch.autograd import DeviceType
        self._type = DeviceType.CUDA if device else DeviceType.CPU
        self._values = (name, start, duration, correlation, linked, thread,
                        annotation)

    def device_type(self):
        return self._type

    def name(self):
        return self._values[0]

    def start_ns(self):
        return self._values[1]

    def duration_ns(self):
        return self._values[2]

    def correlation_id(self):
        return self._values[3]

    def linked_correlation_id(self):
        return self._values[4]

    def start_thread_id(self):
        return self._values[5]

    def is_user_annotation(self):
        return self._values[6]


class _Profiler:
    def __init__(self, events):
        results = type("Results", (), {"events": lambda _: events})()
        self.profiler = type("Profile", (), {"kineto_results": results})()


def test_calls_made_in_no_op_are_read_by_name():
    # A launch made straight inside a span links to no op: its call is
    # known by its API name, and an op that happens to carry the same
    # correlation number is no call.
    events = [
        _Event("aesmc.cdf", False, 0, 100, 7, annotation=True),
        _Event("aesmc.cdf", True, 40, 6, 7, annotation=True),
        _Event("cudaLaunchKernelExC", False, 10, 5, 530),
        _Event("aten::mul", False, 200, 5, 530),
        _Event("cdf_kernel", True, 40, 6, 530),
        _Event("aten::add", False, 20, 30, 9),
        _Event("cudaLaunchKernel", False, 25, 5, 531, linked=9),
        _Event("add_kernel", True, 50, 2, 531),
    ]
    ranges, calls, device = trace._span_events(_Profiler(events))
    assert ranges == [("aesmc.cdf", 1, 0, 100)]
    assert calls == [(1, 10, 530), (1, 25, 531)]
    assert device == [(530, 40, 46), (531, 50, 52)]
    found = trace.spans(_Profiler(events))
    assert found == {"aesmc.cdf": {"occurrences": 1, "launches": 2,
                                   "seconds": pytest.approx(8e-9)}}
