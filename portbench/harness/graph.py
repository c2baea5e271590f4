"""Capturing a call in a CUDA graph, as a user of the port does it for
speed: one warm-up call on a side stream, then the capture with the noise
source's generator registered, so that every replay draws fresh noise."""

from __future__ import annotations

from collections import deque

import torch


def capture(fn, generator: torch.Generator):
    """(graph, what the captured call returned)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(generator)
    with torch.cuda.graph(graph):
        out = fn()
    return graph, out


class Ahead:
    """Keeps at most ``depth`` calls in flight: the host dispatches ahead
    of the device but cannot run away from it. Every ``every`` calls it
    records a timing event, so that the window's stretches can be told
    apart afterwards (`stretch_ms`)."""

    def __init__(self, depth: int = 4, every: int = 32):
        self.depth = depth
        self.every = every
        self.events = deque()
        self.timed = []
        self.count = 0

    def launched(self) -> None:
        self.count += 1
        event = torch.cuda.Event(enable_timing=self.count % self.every == 0)
        event.record()
        if self.count % self.every == 0:
            self.timed.append(event)
        self.events.append(event)
        if len(self.events) > self.depth:
            self.events.popleft().synchronize()

    def stretch_ms(self) -> list:
        """Milliseconds a call in each stretch of ``every`` calls."""
        return [a.elapsed_time(b) / self.every
                for a, b in zip(self.timed, self.timed[1:])]
