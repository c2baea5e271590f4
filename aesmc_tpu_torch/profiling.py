"""Profiling hooks and a step meter.

Counterpart of `aesmc_tpu.profiling`: `trace` records a `torch.profiler`
trace of the host and the card and writes it as a Chrome trace (viewable
in Perfetto or chrome://tracing), `annotate` names a region of that
timeline, and `StepTimer` is a wall-clock meter that reports
particle-steps per second.
"""

from __future__ import annotations

import contextlib
import pathlib
import time
from typing import Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function


@contextlib.contextmanager
def trace(log_dir: str):
    """Records the host and, when a card is present, the card while the
    block runs, then writes ``log_dir``/trace.json (a Chrome trace).
    Yields the `torch.profiler.profile` object."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    path = pathlib.Path(log_dir)
    path.mkdir(parents=True, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(str(path / "trace.json"))


def annotate(name: str):
    """A named region of the profiler's timeline, usable as a context
    manager or a decorator."""
    return record_function(name)


class StepTimer:
    """Wall-clock meter for training and inference loops.

    The clock is the host's: for work on the card, call
    `torch.cuda.synchronize()` before reading it, or the meter counts the
    enqueue and not the work.

    Example:
        timer = StepTimer(num_timesteps=T, batch_size=B, num_particles=K)
        for batch in data:
            step(...)
            timer.tick()
        print(timer.summary())
    """

    def __init__(self, num_timesteps: Optional[int] = None,
                 batch_size: Optional[int] = None,
                 num_particles: Optional[int] = None):
        self.num_timesteps = num_timesteps
        self.batch_size = batch_size
        self.num_particles = num_particles
        self.reset()

    def reset(self):
        self._start = time.perf_counter()
        self._ticks = 0

    def tick(self, n: int = 1):
        self._ticks += n

    @property
    def elapsed(self) -> float:
        return time.perf_counter() - self._start

    @property
    def steps_per_sec(self) -> float:
        return self._ticks / max(self.elapsed, 1e-12)

    @property
    def particle_steps_per_sec(self) -> Optional[float]:
        if None in (self.num_timesteps, self.batch_size,
                    self.num_particles):
            return None
        return (self.steps_per_sec * self.num_timesteps *
                self.batch_size * self.num_particles)

    def summary(self) -> str:
        parts = [f"{self._ticks} steps in {self.elapsed:.2f}s "
                 f"({self.steps_per_sec:.2f} steps/s)"]
        pps = self.particle_steps_per_sec
        if pps is not None:
            parts.append(f"{pps/1e6:.2f}M particle-steps/s")
        return ", ".join(parts)
