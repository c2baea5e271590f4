"""Profiling hooks and a step meter.

Counterpart of `aesmc_tpu.profiling`: `trace` records a `torch.profiler`
trace of the host and the card and writes it as a Chrome trace (viewable
in Perfetto or chrome://tracing), `annotate` names a region of that
timeline, and `StepTimer` is a wall-clock meter that reports
particle-steps per second.

The program's own spans go through `annotate`, under names that start
with ``aesmc.``:

- ``aesmc.smc.initial``: `inference.infer`'s t = 0 draw and weight;
- ``aesmc.smc.resample``: a step's resampling (`inference._resample_step`:
  the ESS test, the normalisation, the CDF and the kernel), in `infer` and
  in the streaming filter's ``step_fn``;
- ``aesmc.resample.cdf``: the normalised CDF: on the 'cuda' route one
  launch of the CDF kernel (`ops.normalized_cdf_cuda`), otherwise
  `resampling._normalized_cumsum` (the weights' normalisation, the
  cumulative sum, its running max, the division by the total and the
  pinned last entry);
- ``aesmc.resample.kernel``: the positions and the search and gather
  (K1, K3, K4 and K5, or the 'torch' route's plain versions; the dense
  gather of that route, at K <= 1,024, builds its CDF inside it);
- ``aesmc.smc.propose``: a step's proposal, its draw and its log-prob;
- ``aesmc.smc.weigh``: the transition and emission log-probs and the new
  log-weight;
- ``aesmc.smc.estimate``: after `infer`'s time loop, the log-Z sum, the
  final logsumexp and the lineage tracing;
- ``aesmc.online.copy_in`` and ``aesmc.online.replay``: a served
  observation's copy into a `online.CapturedStep`'s input and the graph's
  replay.

They appear in any `trace` and in any other `torch.profiler` session, as
host ranges on the profiler's clock; the card's kernels are tied to them
by the profiler's correlation ids. While no session records, a span costs
one check of the profiler's state.
"""

from __future__ import annotations

import contextlib
import functools
import pathlib
import time
from typing import Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from .ops import _launch

# Whether a profiler session records on this thread (a flag read in C++).
_recording = torch._C._autograd._profiler_enabled


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


class _Idle:
    """A span while nothing records: entering and leaving it call nothing
    in PyTorch. One is made a name and shared by every call. As a
    decorator (applied, as a rule, while nothing records) it spans each
    later call of the function."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with annotate(name):
                return fn(*args, **kwargs)
        return spanned


_idle: dict = {}


def annotate(name: str):
    """A named region of the profiler's timeline, usable as a context
    manager or a decorator.

    While a profiler session records it returns a `record_function` range.
    While none records, or while PyTorch traces the caller (`torch.export`,
    which would otherwise record the range as an operator), it returns the
    name's shared no-op span, after one check of the profiler's state."""
    if not _recording() or _launch.tracing():
        span = _idle.get(name)
        if span is None:
            span = _idle.setdefault(name, _Idle(name))
        return span
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
