#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU.

Run from the root of the repository, on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, in order; any failure raises and the exit code is not 0:

1. device: a CUDA card must be present (there is no CPU path); prints
   `nvidia-smi`'s name and power limit of the card;
2. build: builds the six CUDA kernel sources of the port from
   `aesmc_tpu_torch/csrc/`, one nvcc each, all started together, into
   `aesmc_tpu_torch/_build/` (or the user's cache directory when the
   package cannot be written);
3. kernels against their plain PyTorch versions on the same inputs on the
   card, at the main paths' shapes, at other shapes up to K = 8,388,608
   and at degenerate weights:
   - K1, the fused systematic resample+gather: exactly equal (indices and
     gathered values), index output on and off, at the edges of its tiles
     (K = 1,024, 1,025, 2,049) and of its shared-memory window (K = 8,192,
     8,193), and at D = 1, 13 and 300;
   - K2, the range sum (the backward of K1 and K3): exactly equal with
     integer cotangents in [-5, 5] (every sum is then exact in float32),
     each source within 1e-5 x its segment's sum of |g| with float
     cotangents, and the same bits on two launches, up to a row of
     8,388,608 slots on one particle and with the mass on a row's first
     or last particle;
   - K3, the search + gather over loaded sorted positions: exactly equal
     on K1's cases with systematic, stratified and multinomial positions,
     on Kp != K, and at (2, 4,194,304, 4,096), whose windows exceed the
     shared-memory cap;
   - K5, the gather by sorted indices: bit-equal for int32 (negative and
     above 2^24), int64, int8, bool, float64 and float32, D in {1, 5, 8,
     64}, at K = 256 and 257 (one slot a thread up to 256), K = 8,388,608
     and B = 65,536, on indices from resampling and all-equal ones;
     timed at (B, K, D) = (10, 100, 1), (2, 256, 1) (the HMM train
     step's), (10, 10,000, 1), (10, 10,000, 8), (10, 10,000, 64) and
     (4, 8,388,608, 1);
   - K4, the index-only sorted search: exactly equal to
     torch.searchsorted for stratified and multinomial positions up to
     K = 4,194,304, at Kc != Kp, and at (2, 4,194,304, 4,096), whose
     windows exceed the shared-memory cap (one row on one particle takes
     the staged path);
   - K6, the fused CDF + search + gather: indices equal to its plain
     version's (both build the same fixed-point CDF), its gathered values
     the values at its own indices, up to (2, 4,194,304), on one particle
     a row, runs of -inf weight, Kp != K both ways, positions in no order
     and D in {0, 1, 2, 3}; timed at (10, 10,000), (10, 1,000), one
     particle a row at (10, 10,000) and (2, 4,194,304);
   - every kernel at B = 65,536 rows (more than a grid's second dimension
     holds) and K = 4, exact;
   each is timed against its plain version (CUDA events; plain, kernel,
   kernel, plain), K1 also with indices only, K1-K3 also with all mass on
   one particle and on runs of -inf weight, K4 and K5 also against the
   one PyTorch call that computes their function and K2 against
   `scatter_add_` over the forward's ancestors, and its device time read
   from torch.profiler (the library call's too, over all its kernels);
   the host cost of K4's wrapper is broken down into its pieces;
4. filter: the LGSSM SMC filter at the bench's shape (T=200, B=10,
   K=10,000) through `inference.infer`: the log-Z-only call launches K1
   T-1 times; the lineage call agrees exactly with the plain route; with
   the optimal proposal log-Z lies within 5% of the Kalman filter; times
   the filter and K1 against their plain versions with CUDA events, and
   prints torch.profiler's device time by kernel for one filter call;
5. train: the AESMC train step (`train.make_train_step`) on the bench's
   LGSSM at the reference training shape (T=200, B=10, K=100): one step
   launches K1 and K2 T-1 times each; the loss equals the plain route's
   exactly and the gradients agree within rtol 1e-5; times the step on
   both routes and at K=10,000 (with peak memory), prints a profile of
   one step, runs one stratified and one multinomial step (K3 and K2,
   T-1 launches each), and a short parameter-recovery run of
   `train.train` that must halve the parameters' distance to the truth;
6. HMM filter: the discrete HMM (D=8 states, the fully adapted proposal,
   int32 particles) at the bench's shape (T=200, B=10, K=10,000): the
   log-Z-only call launches K1 (indices only) and K5 T-1 times each, a
   stratified call K4 and K5 T-1 times each; the lineage call
   equals the plain route exactly; log-Z against the exact forward
   recursion at the JAX test's settings over 8 noise seeds; times both
   routes and prints a profile of one call;
7. HMM training: the JAX package's emission-learning test on the card
   (the loss must fall by more than 0.5 and the learned means land near
   the truth);
8. graphed train step: `train.train_on_device` on the bench's LGSSM at
   (T, B, K) = (200, 10, 100), 600 steps in blocks of 100, one step
   captured in a CUDA graph: its first 8 steps against 8 eager
   `make_train_step` steps from the same seed (bit-equal), fresh noise at every replay (lr 0: every replay's loss
   differs), the transition learned (|mult - 0.9| < 0.45, the last 30
   losses below the first 30), ms/step from CUDA events around blocks
   beside the eager step, the plain route graphed the same way, one
   replay under torch.profiler (199 K1 and 199 K2 kernel events on the
   kernel route, none on the plain route; the idle share against CUDA
   events around the same profiled replay) and a few graphed steps at
   K = 10,000 with peak memory;
9. graphed filters: one `inference.infer` call of the LGSSM filter at
   (200, 10, 10,000) and of the HMM filter (D = 8) captured in a CUDA
   graph: a replay's log-Z equals an eager call's from the same generator
   state, the next replay differs, one replay runs K1 199 times (and K5
   199 times for the HMM) under torch.profiler, and replays are timed
   against eager calls in turns;
10. ESS-adaptive resampling (frac 0.5) on the LGSSM filter at
   (200, 10, 10,000) against the Kalman filter (< 5% a row, K1 199
   launches) and one adaptive train step at K = 100 (K1 and K2); the NaN
   guard (a NaN step raises FloatingPointError and leaves the parameters
   and Adam's state bit-identical); remat at (200, 10, 10,000): the loss
   equals the plain step's, the gradients within 1e-5 relative, and both
   peak memories.

It prints a `{"kernels": [...]}` JSON line before the last, and, as the
last line, `{"ok": true, "device": {...}}`. It imports nothing of JAX.

    python3 chip_smoke.py --compare DIR

runs phases 1 and 2, then times each kernel against another version of it
built from the sources in DIR (for example an earlier commit's, from
`git show <commit>:aesmc_tpu_torch/csrc/<file>`), on the same inputs, in
turns, by torch.profiler's device time a launch, and drives no path.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import ctypes
import json
import math
import pathlib
import subprocess
import time

import numpy as np
import torch

from aesmc_tpu_torch import (distributions, inference, losses, resampling,
                             statistics, train)
from aesmc_tpu_torch.models import hmm, kalman, lgssm
from aesmc_tpu_torch.noise import NoiseSource
from aesmc_tpu_torch.state import BatchShapeMode
from aesmc_tpu_torch.ops import (_build, _launch, gather_sorted_cuda,
                                 range_sum_cuda, resample_cuda,
                                 resample_sorted_cuda, searchsorted_cdf_cuda,
                                 searchsorted_sorted_cuda)

T, B, K = 200, 10, 10000
# The reference training shape (bench.py:264).
TRAIN_K = 100
# The bench's LGSSM (bench.py): x_0 ~ N(0, 1), x_t = 0.9 x_{t-1} + N(0, 1),
# y_t = x_t + N(0, 0.2^2).
TRANSITION_MULT, TRANSITION_SCALE = 0.9, 1.0
EMISSION_MULT, EMISSION_SCALE = 1.0, 0.2
# The repo's Kalman-oracle bound on log-Z (tests/test_inference.py).
LOG_Z_REL_TOL = 0.05
# K2 with float cotangents: each source's error against the plain version
# within this fraction of its segment's sum of |g| (the two add in
# different orders; the plain version's scatter_add uses atomics).
RANGE_SUM_REL_TOL = 1e-5
# Train step, kernel route against plain route on the same noise: the
# loss is exactly equal (bit-exact ancestors); each gradient entry within
# this relative tolerance (only the order of the backward's sums differs).
GRAD_RTOL = 1e-5

# The card's published peaks (NVIDIA H100 SXM data sheet, at 700 W): HBM
# bandwidth, and float32 outside the tensor cores. A kernel's bound is the
# larger of its bytes over the first and its operations over the second.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

# The JAX bench's HMM row (bench.py:240-259): D=8 states, the fully
# adapted proposal, at the LGSSM's (T, B, K).
HMM_STATES = 8
# The JAX package's HMM test settings (tests/test_hmm.py:18-28): D=3,
# T=25, B=2, K=2048, emission scale 0.6, stay probability 0.85.
HMM_TEST = dict(num_states=3, emission_scale=0.6, stay_prob=0.85)
HMM_TEST_T, HMM_TEST_B, HMM_TEST_K = 25, 2, 2048
# log-Z against the forward recursion over 8 noise seeds, multinomial
# resampling: the mean deviation of each row below the JAX test's bound,
# and the largest below three times it (one seed can miss the bound by
# Monte Carlo noise alone).
HMM_SEEDS, HMM_MEAN_TOL, HMM_MAX_TOL = 8, 0.05, 0.15
# name: (wrapper module, its launch count, the kernel's name in the
# profiler, the TPU kernel it replaces).
KERNELS = {
    "resample_systematic": (resample_cuda, "LAUNCHES",
                            "resample_systematic_kernel",
                            "aesmc_tpu/ops/resample_pallas.py:385"),
    "range_sum": (range_sum_cuda, "LAUNCHES", "range_sum_kernel",
                  "aesmc_tpu/ops/resample_pallas.py:961"),
    "resample_sorted": (resample_sorted_cuda, "LAUNCHES",
                        "resample_sorted_kernel",
                        "aesmc_tpu/ops/resample_pallas.py:945"),
    "searchsorted_sorted": (searchsorted_sorted_cuda, "LAUNCHES",
                            "searchsorted_sorted_kernel",
                            "aesmc_tpu/ops/resample_pallas.py:1024"),
    "gather_sorted": (gather_sorted_cuda, "LAUNCHES", "gather_sorted_kernel",
                      "aesmc_tpu/ops/gather_pallas.py:46"),
    "searchsorted_cdf": (searchsorted_cdf_cuda, "LAUNCHES",
                         "searchsorted_cdf_kernel",
                         "aesmc_tpu/ops/resample_pallas.py:975"),
}

# Kernel launches on each main path, read from the wrappers' counts.
LAUNCHES = {name: {} for name in KERNELS}
# Medians (ms) and peak memory (MiB) of the eager paths, for the graphed
# ones to stand beside.
EAGER_MS = {}


def phase(name):
    print(f"== {name}", flush=True)


def reset_counts():
    for module, counter, _, _ in KERNELS.values():
        setattr(module, counter, 0)


def read_counts(path):
    """Records each kernel's launches on ``path`` since `reset_counts`."""
    torch.cuda.synchronize()
    counts = {name: getattr(module, counter)
              for name, (module, counter, _, _) in KERNELS.items()}
    for name, n in counts.items():
        if n:
            LAUNCHES[name][path] = n
    print(f"launches on {path}: {counts}", flush=True)
    return counts


def device_phase():
    phase("1 device")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "torch.cuda.is_available() is False: chip_smoke.py drives the "
            "port on a CUDA card and has no CPU path")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip()
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    return torch.device("cuda", 0)


def build_phase():
    phase("2 build")
    sources = sorted({module.SOURCE for module, _, _, _ in KERNELS.values()})
    # Build from the sources in this checkout, never from a stale library.
    for source in sources:
        _build.library_path(source).unlink(missing_ok=True)
    start = time.perf_counter()
    _build.load_all(sources)
    seconds = time.perf_counter() - start
    print(f"built {', '.join(sources)} with {_build.nvcc_path()} in "
          f"{seconds:.2f} s (concurrently)", flush=True)


def _case_inputs(batch, k, d, kind, generator, dev):
    logw = torch.randn(batch, k, generator=generator, device=dev) * 3.0
    if kind in HOT:
        # All mass on one particle per row.
        hot = (torch.randint(0, k, (batch,), generator=generator, device=dev)
               if HOT[kind] is None else HOT[kind] % k)
        logw = torch.full((batch, k), float("-inf"), device=dev)
        logw[torch.arange(batch, device=dev), hot] = 0.0
    elif kind == "neg_inf":
        # Runs of zero weight at both ends and inside each row.
        logw[:, : k // 4] = float("-inf")
        logw[:, k // 2: k // 2 + k // 8] = float("-inf")
        logw[:, -3:] = float("-inf")
    cdf = resampling._normalized_cumsum(logw)
    u = torch.rand(batch, 1, generator=generator, device=dev)
    value = torch.randn(batch, k, d, generator=generator, device=dev)
    return cdf, u, value


# The particle that holds all the mass of each row, by kind of case: a
# random one, the first or the last.
HOT = {"one_particle": None, "hot_first": 0, "hot_last": -1}
# (B, K, D, kind). K1's and K3's edges: tiles of 512 slots (K = 1,024,
# 1,025 and 2,049), the 8,192-entry shared-memory window (K = 8,192 takes
# no narrowing round, 8,193 one), and the two ways the tile gather runs:
# D = 1 from registers, D > 1 through shared memory (D = 13 is above the
# TPU kernel's 12-column cap; D = 300 is more columns than a block has
# threads).
CASES = [(10, 10000, 1, "normal"), (3, 1000, 3, "normal"),
         (1, 1, 1, "normal"), (2, 1025, 1, "normal"),
         (1, 8388608, 1, "normal"), (3, 1000, 2, "one_particle"),
         (3, 1000, 2, "neg_inf"), (1, 8388608, 1, "one_particle"),
         (3, 10000, 2, "hot_first"), (3, 10000, 2, "hot_last"),
         (2, 1024, 1, "normal"), (2, 2049, 13, "normal"),
         (2, 8192, 1, "normal"), (2, 8193, 3, "normal"),
         (3, 10000, 13, "normal"), (2, 1025, 300, "normal")]


def k1_phase(dev):
    """K1 against its plain version on the card; returns the max abs error."""
    phase("3a K1 resample_systematic against its plain version")
    generator = torch.Generator(device=dev)
    generator.manual_seed(0)
    worst = 0.0
    for batch, k, d, kind in CASES:
        cdf, u, value = _case_inputs(batch, k, d, kind, generator, dev)
        for emit_idx in (True, False):
            idx, out = resample_cuda.resample_and_gather_systematic(
                cdf, u, value, emit_idx)
            want_idx, want = \
                resample_cuda.resample_and_gather_systematic_torch(
                    cdf, u, value, emit_idx)
            torch.cuda.synchronize()
            err = float((out - want).abs().max())
            worst = max(worst, err)
            if emit_idx:
                mismatches = int((idx != want_idx).sum())
                if mismatches:
                    raise AssertionError(
                        f"K1 indices differ from the plain version at "
                        f"{(batch, k, d, kind)}: {mismatches} of "
                        f"{batch * k}")
            elif idx is not None:
                raise AssertionError("emit_idx=False returned indices")
            if not torch.equal(out, want):
                raise AssertionError(
                    f"K1 gathered values differ from the plain version at "
                    f"{(batch, k, d, kind)}, emit_idx={emit_idx}: max abs "
                    f"error {err}")
            print(f"(B, K, D) = {(batch, k, d)} {kind:12s} "
                  f"emit_idx={emit_idx!s:5s}: exact (tolerance 0)",
                  flush=True)
    return worst


def _sorted_cases(generator, dev):
    """(label, cdf, pos, value) for K2 and K3: K1's cases with systematic,
    stratified and multinomial positions, and three cases with Kp != K,
    the last with windows over the shared-memory cap (K3's and K2's tiles
    of 512 and 1,024 positions span about 500,000 and 1,000,000 CDF
    entries)."""
    for batch, k, d, kind in CASES:
        cdf, u, value = _case_inputs(batch, k, d, kind, generator, dev)
        yield ((batch, k, k, d), kind, "systematic", cdf,
               resample_cuda.systematic_positions(u, k), value)
        noise = NoiseSource(generator)
        for method in ("stratified", "multinomial"):
            pos = resampling.resampling_positions(cdf, noise, method)
            yield (batch, k, k, d), kind, method, cdf, pos, value
    for batch, k, kp, d in ((2, 2048, 512, 1), (2, 512, 2048, 2),
                            (2, 4194304, 4096, 1)):
        cdf, u, value = _case_inputs(batch, k, d, "normal", generator, dev)
        yield ((batch, k, kp, d), "normal", "systematic", cdf,
               resample_cuda.systematic_positions(u, kp), value)


def _bits(x):
    return x.view(torch.int32)


def k2_phase(dev):
    """K2 against its plain version; returns the max abs error with float
    cotangents."""
    phase("3b K2 range_sum against its plain version")
    generator = torch.Generator(device=dev)
    generator.manual_seed(1)
    worst = 0.0
    for shape, kind, method, cdf, pos, _ in _sorted_cases(generator, dev):
        batch, k, kp, d = shape
        if not bool((pos[:, 1:] >= pos[:, :-1]).all()):
            raise AssertionError(f"{method} positions are not sorted at "
                                 f"{shape}")
        g = torch.randint(-5, 6, (batch, kp, d), generator=generator,
                          device=dev).float()
        got = range_sum_cuda.range_sum(cdf, pos, g)
        again = range_sum_cuda.range_sum(cdf, pos, g)
        want = range_sum_cuda.range_sum_torch(cdf, pos, g)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(
                f"K2 with integer cotangents differs from the plain version "
                f"at {shape} {kind} {method}: max abs error "
                f"{float((got - want).abs().max())}")
        if not torch.equal(_bits(got), _bits(again)):
            raise AssertionError(f"K2 gave other bits on a second launch "
                                 f"at {shape} {kind} {method}")
        g = torch.randn(batch, kp, d, generator=generator, device=dev)
        got = range_sum_cuda.range_sum(cdf, pos, g)
        again = range_sum_cuda.range_sum(cdf, pos, g)
        want = range_sum_cuda.range_sum_torch(cdf, pos, g)
        # Each source's bound: the fraction of its segment's sum of |g|.
        bound = RANGE_SUM_REL_TOL * range_sum_cuda.range_sum_torch(
            cdf, pos, g.abs())
        diff = (got - want).abs()
        err = float(diff.max())
        worst = max(worst, err)
        if not bool((diff <= bound).all()):
            raise AssertionError(
                f"K2 with float cotangents at {shape} {kind} {method}: "
                f"{int((diff > bound).sum())} sources above their bound, max "
                f"abs error {err}")
        bound = float(bound.max())
        if not torch.equal(_bits(got), _bits(again)):
            raise AssertionError(f"K2 gave other bits on a second launch "
                                 f"at {shape} {kind} {method}")
        print(f"(B, K, Kp, D) = {shape} {kind:12s} {method:11s}: integer "
              f"cotangents exact, float max abs error {err:.3g} (each source "
              f"within {RANGE_SUM_REL_TOL:g} x its sum of |g|, largest bound "
              f"{bound:.3g}), two launches bit-identical", flush=True)
    return worst


def k3_phase(dev):
    """K3 against its plain version; returns the max abs error."""
    phase("3c K3 resample_sorted against its plain version")
    generator = torch.Generator(device=dev)
    generator.manual_seed(2)
    worst = 0.0
    for shape, kind, method, cdf, pos, value in _sorted_cases(generator,
                                                              dev):
        for emit_idx in (True, False):
            idx, out = resample_sorted_cuda.resample_and_gather_sorted(
                cdf, pos, value, emit_idx)
            want_idx, want = \
                resample_sorted_cuda.resample_and_gather_sorted_torch(
                    cdf, pos, value, emit_idx)
            torch.cuda.synchronize()
            worst = max(worst, float((out - want).abs().max()))
            if emit_idx and not torch.equal(idx, want_idx):
                raise AssertionError(
                    f"K3 indices differ from the plain version at {shape} "
                    f"{kind} {method}: {int((idx != want_idx).sum())}")
            if not emit_idx and idx is not None:
                raise AssertionError("emit_idx=False returned indices")
            if not torch.equal(out, want):
                raise AssertionError(
                    f"K3 gathered values differ from the plain version at "
                    f"{shape} {kind} {method}, emit_idx={emit_idx}")
        print(f"(B, K, Kp, D) = {shape} {kind:12s} {method:11s}: indices "
              f"and values exact, index output on and off", flush=True)
    return worst


def _cuda_ms(fn, warmup, repeat, each=False):
    """Milliseconds per call of ``fn`` between CUDA events: the mean over
    ``repeat`` calls, or with ``each`` a list with one time per call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True))
              for _ in range(repeat if each else 1)]
    if each:
        for start, end in events:
            start.record()
            fn()
            end.record()
    else:
        events[0][0].record()
        for _ in range(repeat):
            fn()
        events[0][1].record()
    torch.cuda.synchronize()
    times = [start.elapsed_time(end) for start, end in events]
    return times if each else times[0] / repeat


def _quartiles(xs):
    return np.percentile(np.asarray(xs), [25, 50, 75])


def _device_ms(fn, kernel, calls=50):
    """Mean device time of one launch of ``kernel`` over ``calls`` calls of
    ``fn``, from torch.profiler; None if the profiler saw no such kernel."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total_us, count = 0.0, 0
    for event in prof.key_averages():
        if kernel in event.key:
            total_us += getattr(event, "device_time_total",
                                getattr(event, "cuda_time_total", 0.0))
            count += event.count
    return total_us / count / 1e3 if count else None


def _calls_device_ms(fn, calls=50):
    """Mean device time of one call of ``fn`` over ``calls`` calls, summed
    over every kernel, copy and fill it runs on the card (torch.profiler);
    None if the profiler saw none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total_us = sum(getattr(e, "device_time_total",
                           getattr(e, "cuda_time_total", 0.0))
                   for e in prof.key_averages()
                   if getattr(e, "device_type", None) == DeviceType.CUDA)
    return total_us / calls / 1e3 if total_us else None


def _time_pair(kernel_fn, plain_fn, library_fn=None, warmup=20,
               repeat=200):
    """(kernel ms, plain ms, library ms or None, runs): CUDA-event means in
    the order plain, kernel, (library, library,) kernel, plain."""
    fns = {"kernel": kernel_fn, "plain": plain_fn, "library": library_fn}
    order = ("plain", "kernel", "kernel", "plain")
    if library_fn is not None:
        order = ("plain", "kernel", "library", "library", "kernel", "plain")
    runs = {which: [] for which in order}
    for which in order:
        runs[which].append(_cuda_ms(fns[which], warmup, repeat))
    library_ms = (None if library_fn is None else
                  float(np.mean(runs["library"])))
    return (float(np.mean(runs["kernel"])), float(np.mean(runs["plain"])),
            library_ms, runs)


def _bound(nbytes, ops):
    """(bound ms, what bounds it) for moving ``nbytes`` and doing ``ops``
    float32 operations on the card."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / FP32_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                          "operations")


def _us(ms):
    """A device time in microseconds, or 'not measured' for None."""
    return "not measured" if ms is None else f"{ms * 1e3:.2f} us"


def _search_steps(n):
    return math.ceil(math.log2(n + 1))


def _kernel_row(name, shape, kernel_fn, plain_fn, library_fn, nbytes, ops,
                library_label="library call"):
    """Times ``name`` at ``shape`` against its plain version (and the one
    PyTorch call computing its function, where there is one), reads its
    device time (and the library call's), and returns its fields of the
    JSON line."""
    ms, plain_ms, library_ms, runs = _time_pair(kernel_fn, plain_fn,
                                                library_fn)
    device_ms = _device_ms(kernel_fn, KERNELS[name][2])
    library_device_ms = (None if library_fn is None else
                         _calls_device_ms(library_fn))
    bound_ms, bound_by = _bound(nbytes, ops)
    library = ("" if library_ms is None else
               f", {library_label} {library_ms * 1e3:.2f} us/call (runs "
               f"{runs['library']}), device {_us(library_device_ms)} a call")
    print(f"{name} at {shape}: {ms * 1e3:.2f} us/call through the wrapper "
          f"(runs {runs['kernel']}), device {_us(device_ms)} a launch, plain "
          f"{plain_ms * 1e3:.2f} us/call (runs {runs['plain']}){library}; "
          f"bound {bound_ms * 1e3:.3f} us ({bound_by}: {nbytes} bytes, {ops} "
          f"operations)", flush=True)
    return dict(ms=ms, plain_ms=plain_ms, device_ms=device_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
                library_device_ms=library_device_ms, shape=list(shape))


def kernel_times(dev):
    """Times K1, K2 and K3 at the filter's shape (B=10, K=10,000, D=1) and
    the training shape (K=100), each against its plain version, K1 also
    with indices only (D=0), and all three on degenerate weights; returns
    the JSON fields of each kernel at (10, 10,000, 1)."""
    phase("3d kernel times against their plain versions")
    out = {}
    for k in (K, TRAIN_K):
        generator = torch.Generator(device=dev).manual_seed(5)
        cdf, u, value = _case_inputs(B, k, 1, "normal", generator, dev)
        pos = resampling.resampling_positions(cdf, NoiseSource(generator),
                                              "stratified")
        g = torch.randn(B, k, 1, generator=generator, device=dev)
        sys_pos = resample_cuda.systematic_positions(u, k)
        n, f = B * k, 4
        steps = _search_steps(k)
        # K2's yardstick: what the plain route's autograd runs, a scatter_add
        # into zeros over the forward's ancestors. It is handed the
        # ancestors, which K2 finds itself, and its atomics make it
        # non-deterministic.
        ancestors = torch.searchsorted(cdf, sys_pos, right=True).clamp_(
            max=k - 1).unsqueeze(-1)
        cases = {
            "resample_systematic": (
                lambda: resample_cuda.resample_and_gather_systematic(
                    cdf, u, value, False),
                lambda: resample_cuda.resample_and_gather_systematic_torch(
                    cdf, u, value, False),
                None, f * (n + B + 2 * n), n * steps),
            "range_sum": (
                lambda: range_sum_cuda.range_sum(cdf, sys_pos, g),
                lambda: range_sum_cuda.range_sum_torch(cdf, sys_pos, g),
                lambda: torch.zeros((B, k, 1), device=dev).scatter_add_(
                    1, ancestors, g),
                f * 4 * n, n * steps + n),
            "resample_sorted": (
                lambda: resample_sorted_cuda.resample_and_gather_sorted(
                    cdf, pos, value, False),
                lambda: resample_sorted_cuda.resample_and_gather_sorted_torch(
                    cdf, pos, value, False),
                None, f * 4 * n, n * steps),
        }
        for name, (kernel_fn, plain_fn, library_fn, nbytes,
                   ops) in cases.items():
            fields = _kernel_row(
                name, (B, k, k, 1), kernel_fn, plain_fn, library_fn, nbytes,
                ops, "scatter_add_ over the given ancestors (non-"
                "deterministic)")
            if k == K:
                out[name] = fields
        # K1 with no value columns and its index output on: the HMM
        # filter's launch.
        no_columns = value.new_empty((B, k, 0))
        _kernel_row(
            "resample_systematic", (B, k, k, 0),
            lambda: resample_cuda.resample_and_gather_systematic(
                cdf, u, no_columns, True),
            lambda: resample_cuda.resample_and_gather_systematic_torch(
                cdf, u, no_columns, True),
            None, f * (n + B + n), n * steps)
        # Degenerate weights. All mass on one particle a row: K2's weak
        # case (one block sums over every later tile alone), and K1's and
        # K3's windows collapse to a few entries. Runs of -inf weight: flat
        # stretches of the CDF under a tile.
        for kind, label in (("one_particle", "all mass on one particle a "
                                             "row"),
                            ("neg_inf", "runs of -inf weight")):
            kind_cdf, kind_u, _ = _case_inputs(B, k, 1, kind, generator, dev)
            kind_pos = resample_cuda.systematic_positions(kind_u, k)
            kind_g = torch.randn(B, k, 1, generator=generator, device=dev)
            fns = {
                "resample_systematic": lambda: (
                    resample_cuda.resample_and_gather_systematic(
                        kind_cdf, kind_u, value, False)),
                "range_sum": lambda: range_sum_cuda.range_sum(
                    kind_cdf, kind_pos, kind_g),
                "resample_sorted": lambda: (
                    resample_sorted_cuda.resample_and_gather_sorted(
                        kind_cdf, pos, value, False)),
            }
            for name, fn in fns.items():
                ms = _cuda_ms(fn, 5, 50)
                device_ms = _device_ms(fn, KERNELS[name][2], calls=10)
                print(f"{name} at ({B}, {k}, 1), {label}: {ms * 1e3:.2f} "
                      f"us/call, device {_us(device_ms)} a launch",
                      flush=True)
    return out


def _host_us(fn, calls=300):
    """Host microseconds per call of ``fn`` over ``calls`` back-to-back
    calls ended by one synchronize (the dispatch cost, where the device
    keeps up)."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - start) / calls * 1e6


def host_costs(dev):
    """Host cost of one resampling step's forward and backward at the
    training shape (B=10, K=100, D=1), kernel route against plain route,
    and of the pieces of the kernel route's backward."""
    phase("3e host cost per resampling step at the training shape")
    generator = torch.Generator(device=dev).manual_seed(6)
    cdf, u, value = _case_inputs(B, TRAIN_K, 1, "normal", generator, dev)
    value.requires_grad_(True)
    g = torch.randn(B, TRAIN_K, 1, generator=generator, device=dev)
    pos = resample_cuda.systematic_positions(u, TRAIN_K)

    def kernel_step():
        _, out = resample_cuda.resample_and_gather_systematic(
            cdf, u, value, False)
        out.backward(g)

    def plain_step():
        _, out = resample_cuda.resample_and_gather_systematic_torch(
            cdf, u, value, False)
        out.backward(g)

    costs = {
        "K1 wrapper, forward only": lambda: (
            resample_cuda.resample_and_gather_systematic(
                cdf, u, value.detach(), False)),
        "plain forward only": lambda: (
            resample_cuda.resample_and_gather_systematic_torch(
                cdf, u, value.detach(), False)),
        "K1 forward + K2 backward": kernel_step,
        "plain forward + backward": plain_step,
        "systematic_positions": lambda: resample_cuda.systematic_positions(
            u, TRAIN_K),
        "K2 wrapper": lambda: range_sum_cuda.range_sum(cdf, pos, g),
        "K2 plain version": lambda: range_sum_cuda.range_sum_torch(cdf, pos,
                                                                   g),
    }
    for label, fn in costs.items():
        print(f"host cost, {label}: {_host_us(fn):.1f} us/call", flush=True)


def _same_bits(a, b):
    """Equal dtype, shape and bits (floats compared by bit pattern)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        as_int = {2: torch.int16, 4: torch.int32, 8: torch.int64}
        a, b = (x.view(as_int[x.element_size()]) for x in (a, b))
    return torch.equal(a, b)


K5_DTYPES = (torch.int32, torch.int64, torch.int8, torch.bool,
             torch.float64, torch.float32)
# (B, K, D) of the K5 checks; rows of at most 256 slots take one slot a
# thread, longer ones four.
K5_SHAPES = [(B, K, 1), (B, K, 8), (B, K, 64), (4, 8388608, 1),
             (65536, 4, 1), (3, 256, 5), (3, 257, 1)]
# (B, K, D) of K5's device times; (2, 256, 1) is the HMM train step's.
K5_TIMES = [(B, 100, 1), (2, 256, 1), (B, K, 1), (B, K, 8), (B, K, 64),
            (4, 8388608, 1)]
# (B, Kc, Kp, kind) of the K4 checks: at (2, 4,194,304, 4,096) every
# tile's window exceeds the shared-memory cap, except on the row whose
# mass sits on one particle (an empty window, staged).
K4_CASES = [(B, K, K, "normal"), (B, 4194304, 4194304, "normal"),
            (4, 1048576, 262144, "normal"),
            (2, 4194304, 4096, "one_particle_row")]
# (B, K, Kp, D, kind) of the K6 checks: positions split over the cluster
# apart from the CDF (Kp != K both ways), positions that are not sorted,
# runs of -inf weight, indices only (D = 0) and D = 3.
K6_CASES = [(B, K, K, 1, "normal"), (B, 1000, 1000, 1, "normal"),
            (B, K, K, 1, "one_particle"), (2, 4194304, 4194304, 1, "normal"),
            (2, 20000, 5000, 3, "normal"), (2, 5000, 20000, 1, "normal"),
            (3, 10000, 10000, 1, "unsorted"), (3, 1000, 4000, 3, "unsorted"),
            (2, 50000, 50000, 1, "neg_inf"), (2, 50000, 50000, 0, "neg_inf"),
            (3, 9, 9, 0, "normal"), (3, 1, 1, 1, "normal"),
            (4, 100000, 100000, 2, "normal")]
# (B, K, kind) of K6's device times; the first goes to the JSON line.
K6_TIMES = [(B, K, "normal"), (B, 1000, "normal"), (B, K, "one_particle"),
            (2, 4194304, "normal")]
# B of the check that every kernel takes more rows than a grid's second
# dimension holds (65,535), at K = ROWS_K.
ROWS_B, ROWS_K = 65536, 4


def _k5_value(dtype, shape, generator, dev):
    if dtype.is_floating_point:
        return torch.randn(shape, generator=generator, device=dev,
                           dtype=dtype)
    bits = torch.randint(-2 ** 31, 2 ** 31 - 1, shape, generator=generator,
                         device=dev, dtype=torch.int64)
    if dtype == torch.bool:
        return bits > 0
    if dtype == torch.int64:
        return bits * (2 ** 31) + bits        # beyond 32 bits
    value = bits.to(dtype)                    # int8 wraps
    if dtype == torch.int32:
        value.view(-1)[:4] = torch.tensor(
            [-1, 2 ** 24 + 1, -(2 ** 30) - 3, 2 ** 31 - 1], dtype=dtype)
    return value


def k5_phase(dev):
    """K5 against its plain version, bit for bit; returns the JSON fields
    of K5 at the HMM filter's shape (10, 10,000), int32 particles."""
    phase("3f K5 gather_sorted against its plain version")
    generator = torch.Generator(device=dev).manual_seed(7)
    for batch, k, d in K5_SHAPES:
        logw = torch.randn(batch, k, generator=generator, device=dev) * 3.0
        resampled = resampling.sample_ancestral_index(logw,
                                                      NoiseSource(generator))
        equal = torch.full((batch, k), k // 2, dtype=torch.int32,
                           device=dev)
        for dtype in K5_DTYPES:
            value = _k5_value(dtype, (batch, k, d), generator, dev)
            for label, idx in (("resampled", resampled),
                               ("all-equal", equal)):
                got = gather_sorted_cuda.gather_sorted(value, idx)
                want = gather_sorted_cuda.gather_sorted_torch(value, idx)
                torch.cuda.synchronize()
                if not _same_bits(got, want):
                    raise AssertionError(
                        f"K5 differs from its plain version at "
                        f"{(batch, k, d)} {dtype} on {label} indices")
        print(f"(B, K, D) = {(batch, k, d)}: bit-equal for "
              f"{', '.join(str(t).split('.')[1] for t in K5_DTYPES)} on "
              f"resampled and all-equal indices (tolerance 0)", flush=True)
    # Device times against the bound, int32 values on resampled indices:
    # the HMM filter's shape (10, 10,000, 1), whose fields go to the JSON
    # line, and four others.
    fields = None
    for batch, k, d in K5_TIMES:
        logw = torch.randn(batch, k, generator=generator, device=dev) * 3.0
        idx = resampling.sample_ancestral_index(logw, NoiseSource(generator))
        shape = (batch, k) if d == 1 else (batch, k, d)
        latents = _k5_value(torch.int32, shape, generator, dev)
        index = idx.long() if d == 1 else idx.long().unsqueeze(-1)
        n = batch * k
        row = _kernel_row(
            "gather_sorted", (batch, k, d),
            lambda: gather_sorted_cuda.gather_sorted(latents, idx),
            lambda: gather_sorted_cuda.gather_sorted_torch(latents, idx),
            lambda: torch.take_along_dim(latents, index, dim=1),
            4 * n + 2 * 4 * n * d, 0)
        if (batch, k, d) == (B, K, 1):
            fields = row
    return fields


def _k4_case(batch, kc, kind, generator, dev):
    """A `[batch, kc]` CDF from N(0, 3^2) log-weights; with kind
    'one_particle_row' the last row holds all its mass on one particle."""
    logw = torch.randn(batch, kc, generator=generator, device=dev) * 3.0
    if kind == "one_particle_row":
        logw[-1] = float("-inf")
        logw[-1, kc // 3] = 0.0
    return resampling._normalized_cumsum(logw)


def k4_phase(dev):
    """K4 against torch.searchsorted, exactly, and the host cost of its
    wrapper; returns its JSON fields at (10, 10,000), stratified
    positions."""
    phase("3g K4 searchsorted_sorted against torch.searchsorted")
    generator = torch.Generator(device=dev).manual_seed(8)
    for batch, kc, kp, kind in K4_CASES:
        cdf = _k4_case(batch, kc, kind, generator, dev)
        for method in ("stratified", "multinomial"):
            pos = resampling.resampling_positions(
                cdf.new_zeros(batch, kp), NoiseSource(generator), method)
            got = searchsorted_sorted_cuda.searchsorted_sorted(cdf, pos)
            want = searchsorted_sorted_cuda.searchsorted_sorted_torch(cdf,
                                                                      pos)
            library = torch.searchsorted(cdf, pos, right=True)
            torch.cuda.synchronize()
            if not (torch.equal(got, want) and
                    torch.equal(got.long(), library.clamp(max=kc - 1))):
                raise AssertionError(
                    f"K4 differs from torch.searchsorted at "
                    f"{(batch, kc, kp)} {kind} {method}: "
                    f"{int((got != want).sum())} indices")
            print(f"(B, Kc, Kp) = {(batch, kc, kp)} {kind:16s} {method:11s}: "
                  f"equal to torch.searchsorted (tolerance 0)", flush=True)
    logw = torch.randn(B, K, generator=generator, device=dev) * 3.0
    cdf = resampling._normalized_cumsum(logw)
    pos = resampling.resampling_positions(logw, NoiseSource(generator),
                                          "stratified")
    n = B * K
    fields = _kernel_row(
        "searchsorted_sorted", (B, K, K, 0),
        lambda: searchsorted_sorted_cuda.searchsorted_sorted(cdf, pos),
        lambda: searchsorted_sorted_cuda.searchsorted_sorted_torch(cdf, pos),
        lambda: torch.searchsorted(cdf, pos, right=True),
        4 * 3 * n, n * _search_steps(K))

    # The host cost of the wrapper against the library call, and of each
    # piece of the wrapper.
    module = searchsorted_sorted_cuda
    fn = _launch.entry(module.SOURCE, module._SYMBOL, module._ARGTYPES)
    idx = torch.empty((B, K), dtype=torch.int32, device=dev)
    card, stream = _launch.target(cdf)
    pieces = {
        "K4 wrapper (searchsorted_sorted)": lambda: module.searchsorted_sorted(
            cdf, pos),
        "torch.searchsorted": lambda: torch.searchsorted(cdf, pos,
                                                         right=True),
        "  its checks (_check)": lambda: module._check(cdf, pos),
        "  the bound C entry (_launch.entry, a dict lookup)": lambda: (
            _launch.entry(module.SOURCE, module._SYMBOL, module._ARGTYPES)),
        "  the output (torch.empty_like)": lambda: torch.empty_like(
            pos, dtype=torch.int32),
        "  the output (torch.empty, the earlier wrapper's)": lambda: (
            torch.empty((B, K), dtype=torch.int32, device=dev)),
        "  card and raw stream (_launch.target)": lambda: _launch.target(
            cdf),
        "  card and stream object (the earlier wrapper's)": lambda: (
            cdf.device.index,
            torch.cuda.current_stream(cdf.device.index).cuda_stream),
        "  the ctypes call and launch": lambda: fn(
            cdf.data_ptr(), pos.data_ptr(), idx.data_ptr(), B, K, K, card,
            stream),
    }
    for label, piece in pieces.items():
        print(f"host cost, {label}: {_host_us(piece):.2f} us/call",
              flush=True)
    return fields


def _k6_inputs(batch, k, kind, generator, dev, kp=None, d=1):
    """K6's log-weights N(0, 2^2) (the JAX package's test's), with all mass
    on one particle a row ('one_particle') or with two runs of -inf weight
    ('neg_inf'); Kp (default K) systematic positions, or uniform ones in no
    order ('unsorted'); D value columns (None for D = 0)."""
    kp = k if kp is None else kp
    logw = torch.randn(batch, k, generator=generator, device=dev) * 2.0
    if kind == "one_particle":
        hot = torch.randint(0, k, (batch,), generator=generator, device=dev)
        logw = torch.full((batch, k), float("-inf"), device=dev)
        logw[torch.arange(batch, device=dev), hot] = 0.0
    elif kind == "neg_inf":
        logw[:, :k // 4] = float("-inf")
        logw[:, k // 2:k // 2 + k // 8] = float("-inf")
    if kind == "unsorted":
        pos = torch.rand(batch, kp, generator=generator, device=dev)
    else:
        u = torch.rand(batch, 1, generator=generator, device=dev)
        pos = resample_cuda.systematic_positions(u, kp)
    value = (None if d == 0 else
             torch.randn(batch, k, d, generator=generator, device=dev))
    return logw, pos, value


def _k6_check(logw, pos, value, label):
    """K6 against its plain version: both build the same fixed-point CDF,
    so every index must be equal (tolerance 0), and the gathered values
    must be exactly those at its own indices."""
    if value is None:
        idx = searchsorted_cdf_cuda.searchsorted_cdf(logw, pos)
        want_idx = searchsorted_cdf_cuda.searchsorted_cdf_torch(logw, pos)
    else:
        idx, out = searchsorted_cdf_cuda.searchsorted_cdf(logw, pos, value)
        want_idx, _ = searchsorted_cdf_cuda.searchsorted_cdf_torch(
            logw, pos, value)
    torch.cuda.synchronize()
    if not torch.equal(idx, want_idx):
        differ = idx != want_idx
        raise AssertionError(
            f"K6 indices differ from its plain version at {label}: "
            f"{int(differ.sum())} of {idx.numel()}, by up to "
            f"{int((idx - want_idx).abs().max())} (tolerance 0)")
    if value is not None:
        own = torch.take_along_dim(value, idx.long().unsqueeze(-1), dim=1)
        if not _same_bits(out, own):
            raise AssertionError(f"K6 gathered other values than those at "
                                 f"its indices at {label}")
    print(f"K6 at {label}: all {idx.numel()} indices equal to its plain "
          f"version's (tolerance 0)"
          f"{'' if value is None else '; gathered values exact'}",
          flush=True)


def _k6_against_float64(logw, pos):
    """How far K6's indices, and those of the engine's float32 CDF
    (`_normalized_cumsum`, torch.cumsum), lie from a float64 CDF's."""
    k = logw.shape[1]
    lw = logw.double()
    cum = torch.cumsum(torch.exp(lw - lw.max(dim=1, keepdim=True).values),
                       dim=1)
    exact = torch.searchsorted(cum / cum[:, -1:], pos.double(),
                               right=True).clamp_(max=k - 1)
    float32 = torch.searchsorted(resampling._normalized_cumsum(logw), pos,
                                 right=True).clamp_(max=k - 1)
    for label, idx in (("K6", searchsorted_cdf_cuda.searchsorted_cdf(
            logw, pos).long()), ("a float32 torch.cumsum CDF", float32)):
        off = (idx - exact).abs()
        print(f"K6 at {tuple(logw.shape)}: {label} against a float64 CDF: "
              f"{float((off > 0).float().mean()):.4%} of indices differ, by "
              f"at most {int(off.max())}", flush=True)


def k6_phase(dev):
    """K6 against its plain version, exactly, and its entry point as its
    path; returns its JSON fields at (10, 10,000, 1)."""
    phase("3h K6 searchsorted_cdf against its plain version")
    generator = torch.Generator(device=dev).manual_seed(9)
    for batch, k, kp, d, kind in K6_CASES:
        logw, pos, value = _k6_inputs(batch, k, kind, generator, dev, kp, d)
        _k6_check(logw, pos, value, f"(B, K, Kp, D) = {(batch, k, kp, d)} "
                                    f"{kind}")
        if k >= 1000000:
            _k6_against_float64(logw, pos)

    logw, pos, value = _k6_inputs(B, K, "normal", generator, dev)
    # Its path is its entry point, called once as a user would.
    reset_counts()
    searchsorted_cdf_cuda.searchsorted_cdf(logw, pos, value)
    if read_counts("K6 entry point")["searchsorted_cdf"] != 1:
        raise AssertionError("searchsorted_cdf did not launch K6 once")
    fields = None
    for batch, k, kind in K6_TIMES:
        logw, pos, value = _k6_inputs(batch, k, kind, generator, dev)
        n = batch * k
        row = _kernel_row(
            "searchsorted_cdf", (batch, k, 1, kind),
            lambda: searchsorted_cdf_cuda.searchsorted_cdf(logw, pos, value),
            lambda: searchsorted_cdf_cuda.searchsorted_cdf_torch(logw, pos,
                                                                 value),
            None, 4 * 5 * n, 4 * n + n * _search_steps(k))
        if fields is None:
            fields = row
            # The port's own route to the same indices (not one PyTorch
            # call): the CDF from torch ops, then K3.
            def port_route():
                cdf = resampling._normalized_cumsum(logw)
                return resample_sorted_cuda.resample_and_gather_sorted(
                    cdf, pos, value)

            route_ms = _cuda_ms(port_route, 20, 200)
            print(f"the port's route (_normalized_cumsum + K3) at "
                  f"{(batch, k, 1)}: {route_ms * 1e3:.2f} us/call, device "
                  f"{_us(_calls_device_ms(port_route))} a call", flush=True)
    return fields


def rows_phase(dev):
    """Every kernel at B = 65,536 rows (more than a grid's second dimension
    holds) and K = 4, against its plain version, exactly."""
    phase(f"3i every kernel at B = {ROWS_B:,} rows, K = {ROWS_K}")
    generator = torch.Generator(device=dev).manual_seed(10)
    cdf, u, value = _case_inputs(ROWS_B, ROWS_K, 2, "normal", generator, dev)
    pos = resampling.resampling_positions(cdf, NoiseSource(generator),
                                          "stratified")
    g = torch.randint(-5, 6, value.shape, generator=generator,
                      device=dev).float()
    ints = _k5_value(torch.int32, (ROWS_B, ROWS_K, 3), generator, dev)
    idx = searchsorted_sorted_cuda.searchsorted_sorted_torch(cdf, pos)
    pairs = {
        "resample_systematic": (
            resample_cuda.resample_and_gather_systematic(cdf, u, value),
            resample_cuda.resample_and_gather_systematic_torch(cdf, u,
                                                               value)),
        "range_sum": (range_sum_cuda.range_sum(cdf, pos, g),
                      range_sum_cuda.range_sum_torch(cdf, pos, g)),
        "resample_sorted": (
            resample_sorted_cuda.resample_and_gather_sorted(cdf, pos, value),
            resample_sorted_cuda.resample_and_gather_sorted_torch(cdf, pos,
                                                                  value)),
        "searchsorted_sorted": (
            searchsorted_sorted_cuda.searchsorted_sorted(cdf, pos), idx),
        "gather_sorted": (gather_sorted_cuda.gather_sorted(ints, idx),
                          gather_sorted_cuda.gather_sorted_torch(ints, idx)),
    }
    torch.cuda.synchronize()
    for name, (got, want) in pairs.items():
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        if not all(_same_bits(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"{name} differs from its plain version at "
                                 f"B = {ROWS_B}")
        print(f"{name} at (B, K) = {(ROWS_B, ROWS_K)}: exact (tolerance 0)",
              flush=True)
    logw, pos, value = _k6_inputs(ROWS_B, ROWS_K, "normal", generator, dev)
    _k6_check(logw, pos, value, f"(B, K, D) = {(ROWS_B, ROWS_K, 1)} normal")


@torch.no_grad()
def filter_phase(dev):
    phase("4 filter: LGSSM SMC, T=200, B=10, K=10,000")
    initial = lgssm.Initial(0.0, 1.0)
    transition = lgssm.Transition(TRANSITION_MULT, TRANSITION_SCALE).to(dev)
    emission = lgssm.Emission(EMISSION_MULT, EMISSION_SCALE).to(dev)
    # bench.py's proposal: random affine weights from a seed.
    proposal = lgssm.Proposal.create(
        1.0, 1.0, torch.Generator().manual_seed(0)).to(dev)
    optimal = lgssm.optimal_proposal(
        0.0, 1.0, TRANSITION_MULT, TRANSITION_SCALE, EMISSION_MULT,
        EMISSION_SCALE).to(dev)

    _, obs = statistics.sample_from_prior(initial, transition, emission, T,
                                          B, NoiseSource.seeded(0, dev))

    def smc(prop, seed, implementation="auto", **returns):
        return inference.infer(
            "smc", obs, initial, transition, emission, prop, K,
            noise=NoiseSource.seeded(seed, dev),
            resampling_implementation=implementation,
            return_log_marginal_likelihood=True, **returns)

    # The main path: log-Z only, so K1 runs without its index output.
    reset_counts()
    out = smc(proposal, 1, return_latents=False, return_log_weight=False)
    launches = read_counts("filter")["resample_systematic"]
    log_z = out["log_marginal_likelihood"]
    if launches != T - 1:
        raise AssertionError(f"K1 launched {launches} times, not {T - 1}")
    if log_z.shape != (B,) or not bool(torch.isfinite(log_z).all()):
        raise AssertionError(f"bad log-Z {log_z}")
    print(f"log-Z-only call: {launches} K1 launches (emit_idx off), "
          f"log-Z {log_z.cpu().numpy()}", flush=True)

    # Lineage outputs turn the index output on; the plain route with the
    # same seed must give the same ancestors, latents and log-Z.
    resample_cuda.LAUNCHES = 0
    kern = smc(proposal, 2, return_ancestral_indices=True)
    torch.cuda.synchronize()
    if resample_cuda.LAUNCHES != T - 1:
        raise AssertionError(
            f"lineage call launched K1 {resample_cuda.LAUNCHES} times")
    plain = smc(proposal, 2, "torch", return_ancestral_indices=True)
    anc = kern["ancestral_indices"]
    if anc.shape != (T - 1, B, K) or anc.dtype != torch.int32:
        raise AssertionError(f"bad ancestors {anc.shape} {anc.dtype}")
    mismatches = int((anc != plain["ancestral_indices"]).sum())
    if mismatches or not torch.equal(kern["latents"], plain["latents"]):
        raise AssertionError(
            f"lineage call differs from the plain route: {mismatches} "
            f"ancestors")
    lz_err = float((kern["log_marginal_likelihood"] -
                    plain["log_marginal_likelihood"]).abs().max())
    if lz_err != 0.0:
        raise AssertionError(f"log-Z differs from the plain route: {lz_err}")
    print(f"lineage call (emit_idx on): ancestors {tuple(anc.shape)} and "
          f"latents {tuple(kern['latents'].shape)} equal the plain route's",
          flush=True)

    # Accuracy against the exact Kalman filter, optimal proposal.
    est = smc(optimal, 3, return_latents=False)["log_marginal_likelihood"]
    params = kalman.KalmanParams(
        initial_mean=0.0, initial_variance=1.0,
        transition_mult=TRANSITION_MULT, transition_offset=0.0,
        transition_variance=TRANSITION_SCALE ** 2,
        emission_mult=EMISSION_MULT, emission_offset=0.0,
        emission_variance=EMISSION_SCALE ** 2)
    obs_np = obs.cpu().numpy()
    exact = np.array([kalman.kalman_filter(obs_np[:, b], params)[4]
                      for b in range(B)])
    rel = np.abs(est.cpu().numpy() - exact) / np.abs(exact)
    print(f"log-Z vs Kalman, optimal proposal: max relative error "
          f"{rel.max():.3e} (bound {LOG_Z_REL_TOL})", flush=True)
    if not np.all(rel < LOG_Z_REL_TOL):
        raise AssertionError(f"log-Z off the Kalman filter: {rel}")

    # Times: plain, kernel, kernel, plain, all in this one process.
    def filt(implementation):
        return lambda: smc(proposal, 4, implementation,
                           return_latents=False, return_log_weight=False)

    torch.cuda.reset_peak_memory_stats()
    slice_ms = {"torch": [], "cuda": []}
    for implementation in ("torch", "cuda", "cuda", "torch"):
        slice_ms[implementation] += _cuda_ms(
            filt(implementation), warmup=2, repeat=5, each=True)
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    for implementation, label in (("cuda", "K1 route"),
                                  ("torch", "plain route")):
        q1, med, q3 = _quartiles(slice_ms[implementation])
        print(f"SMC log-Z call, {label}: median {med:.3f} ms/call "
              f"(quartiles {q1:.3f}, {q3:.3f}; n="
              f"{len(slice_ms[implementation])}) = "
              f"{B * K * T / med * 1e3:.4g} particle-steps/s", flush=True)
    print(f"peak device memory {peak_mb:.1f} MiB", flush=True)

    cdf, u, value = _case_inputs(B, K, 1, "normal",
                                 torch.Generator(device=dev).manual_seed(5),
                                 dev)
    ms, plain_ms, _, runs = _time_pair(
        lambda: resample_cuda.resample_and_gather_systematic(
            cdf, u, value, True),
        lambda: resample_cuda.resample_and_gather_systematic_torch(
            cdf, u, value, True))
    print(f"K1 at [{B}, {K}], D=1, emit_idx=True: kernel {ms * 1e3:.2f} "
          f"us/call (runs {runs['kernel']}), plain {plain_ms * 1e3:.2f} "
          f"us/call (runs {runs['plain']})", flush=True)
    _profile(filt("cuda"), "one filter call")


def _profile(fn, label):
    """Device time by kernel name over one call of ``fn``."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    print(f"profile of {label}:", flush=True)
    events = prof.key_averages()
    print(events.table(sort_by="cuda_time_total", row_limit=25), flush=True)
    # The port's kernels, wherever they rank.
    for kernel in sorted({name for _, _, name, _ in KERNELS.values()}):
        rows = [e for e in events if kernel in e.key]
        total_us = sum(getattr(e, "device_time_total",
                               getattr(e, "cuda_time_total", 0.0))
                       for e in rows)
        count = sum(e.count for e in rows)
        if count:
            print(f"{kernel}: {total_us / 1e3:.3f} ms of device time in "
                  f"{count} launches ({total_us / count:.2f} us each)",
                  flush=True)


def _bench_lgssm(dev, transition_mult):
    """bench.py's LGSSM components on the card, the transition trainable
    from ``transition_mult``, and observations from the true model."""
    initial = lgssm.Initial(0.0, 1.0)
    emission = lgssm.Emission(EMISSION_MULT, EMISSION_SCALE).to(dev)
    proposal = lgssm.Proposal.create(
        1.0, 1.0, torch.Generator().manual_seed(0)).to(dev)
    with torch.no_grad():
        _, obs = statistics.sample_from_prior(
            initial, lgssm.Transition(TRANSITION_MULT,
                                      TRANSITION_SCALE).to(dev),
            emission, T, B, NoiseSource.seeded(0, dev))
    transition = lgssm.Transition(transition_mult, TRANSITION_SCALE).to(dev)
    return (initial, transition, emission, proposal), obs


def _compare_routes(comps, obs, k, method, seed, dev):
    """The loss and gradients of the kernel route against the plain route
    on the same noise; returns the worst relative gradient error."""
    params = train.get_chained_params(*comps)
    results = {}
    for implementation in ("cuda", "torch"):
        loss = losses.get_loss(obs, k, "aesmc", *comps,
                               noise=NoiseSource.seeded(seed, dev),
                               resampling_method=method,
                               resampling_implementation=implementation)
        results[implementation] = (loss.detach(),
                                   torch.autograd.grad(loss, params))
    (loss_k, grads_k), (loss_t, grads_t) = results["cuda"], results["torch"]
    if not torch.equal(loss_k, loss_t):
        raise AssertionError(
            f"{method} loss differs between the routes: {float(loss_k)} "
            f"vs {float(loss_t)}")
    # Relative to each parameter's largest gradient entry.
    worst = max(float((a - b).abs().max() / b.abs().max())
                for a, b in zip(grads_k, grads_t))
    if worst > GRAD_RTOL:
        raise AssertionError(
            f"{method} gradients differ between the routes: worst relative "
            f"error {worst} above {GRAD_RTOL}")
    print(f"{method} K={k}: loss {float(loss_k):.6f} equal on both routes; "
          f"gradients within relative error {worst:.3g} (bound "
          f"{GRAD_RTOL})", flush=True)
    return worst


def train_phase(dev):
    phase("5 train: AESMC train step, T=200, B=10, K=100")
    comps, obs = _bench_lgssm(dev, 0.5)
    optimizer = torch.optim.Adam(train.get_chained_params(*comps), lr=1e-2)
    _compare_routes(comps, obs, TRAIN_K, "systematic", 11, dev)

    # The main path: one train step as a user calls it.
    step = train.make_train_step(TRAIN_K, "aesmc", optimizer)
    reset_counts()
    loss = step(comps, obs, NoiseSource.seeded(12, dev))
    counts = read_counts("train K=100")
    if (counts["resample_systematic"], counts["range_sum"]) != (T - 1,
                                                                 T - 1):
        raise AssertionError(f"one train step launched {counts}, not K1 "
                             f"and K2 {T - 1} times each")
    if not bool(torch.isfinite(loss)):
        raise AssertionError(f"train step loss {loss}")

    # Step times, plain route against kernel route.
    steps = {impl: train.make_train_step(
        TRAIN_K, "aesmc", optimizer, resampling_implementation=impl)
        for impl in ("cuda", "torch")}
    noise = NoiseSource.seeded(13, dev)
    step_ms = {"cuda": [], "torch": []}
    for impl in ("torch", "cuda", "cuda", "torch"):
        step_ms[impl] += _cuda_ms(lambda: steps[impl](comps, obs, noise),
                                  warmup=2, repeat=6, each=True)
    for impl, label in (("cuda", "kernel route"), ("torch", "plain route")):
        q1, med, q3 = _quartiles(step_ms[impl])
        EAGER_MS[f"train {impl}"] = med
        print(f"AESMC train step K={TRAIN_K}, {label}: median {med:.3f} "
              f"ms/step (quartiles {q1:.3f}, {q3:.3f}; n="
              f"{len(step_ms[impl])}) = {1e3 / med:.2f} steps/s", flush=True)
    _profile(lambda: steps["cuda"](comps, obs, noise),
             f"one train step at K={TRAIN_K}")

    # Stratified and multinomial: K3 forward, K2 backward.
    for method in ("stratified", "multinomial"):
        _compare_routes(comps, obs, TRAIN_K, method, 14, dev)
        method_step = train.make_train_step(TRAIN_K, "aesmc", optimizer,
                                            resampling_method=method)
        reset_counts()
        loss = method_step(comps, obs, NoiseSource.seeded(15, dev))
        counts = read_counts(f"train {method} K=100")
        if (counts["resample_sorted"], counts["range_sum"],
                counts["resample_systematic"]) != (T - 1, T - 1, 0):
            raise AssertionError(f"one {method} step launched {counts}")
        if not bool(torch.isfinite(loss)):
            raise AssertionError(f"{method} step loss {loss}")

    # The filter's width: a few steps at K=10,000, with peak memory.
    big_steps = {impl: train.make_train_step(
        K, "aesmc", optimizer, resampling_implementation=impl)
        for impl in ("cuda", "torch")}
    torch.cuda.reset_peak_memory_stats()
    big_steps["cuda"](comps, obs, noise)
    torch.cuda.synchronize()
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    big_ms = {"cuda": [], "torch": []}
    for impl in ("torch", "cuda", "cuda", "torch"):
        big_ms[impl] += _cuda_ms(lambda: big_steps[impl](comps, obs, noise),
                                 warmup=1, repeat=2, each=True)
    EAGER_MS["train K=10000"] = float(np.median(big_ms["cuda"]))
    EAGER_MS["peak K=10000"] = peak_mb
    for impl, label in (("cuda", "kernel route"), ("torch", "plain route")):
        q1, med, q3 = _quartiles(big_ms[impl])
        print(f"AESMC train step K={K}, {label}: median {med:.3f} ms/step "
              f"(quartiles {q1:.3f}, {q3:.3f}; runs {big_ms[impl]})",
              flush=True)
    print(f"peak device memory of one K={K} step: {peak_mb:.1f} MiB",
          flush=True)

    recovery_phase(dev)


def recovery_phase(dev):
    """The JAX package's LGSSM recovery test (tests/test_train.py:98-129)
    on the card: T=20, B=16, K=50, 150 Adam steps at lr 5e-2 from
    a0 = c0 = 0, from that test's initial proposal."""
    true_a, true_c, a0, c0 = 0.9, 1.0, 0.0, 0.0
    scale_0, scale_t = lgssm.optimal_proposal_scales(1.0, 1.0, true_c, 0.1)
    loader = train.get_synthetic_dataloader(
        lgssm.Initial(0.0, 1.0), lgssm.Transition(true_a, 1.0).to(dev),
        lgssm.Emission(true_c, 0.1).to(dev), 20, 16,
        NoiseSource.seeded(0, dev))
    # aesmc_tpu's lgssm.Proposal.create(scale_0, scale_t, PRNGKey(0)).
    proposal = lgssm.Proposal(0.68462825, -0.98541236,
                              [0.5691495, 0.5830701], -0.32952663,
                              scale_0, scale_t).to(dev)
    start = time.perf_counter()
    _, transition, emission, _ = train.train(
        loader, 50, "aesmc", lgssm.Initial(0.0, 1.0),
        lgssm.Transition(a0, 1.0).to(dev), lgssm.Emission(c0, 0.1).to(dev),
        proposal, num_epochs=1, num_iterations_per_epoch=150,
        optimizer_kwargs={"lr": 5e-2}, noise=NoiseSource.seeded(3, dev))
    a, c = transition.mult.item(), emission.mult.item()
    seconds = time.perf_counter() - start
    err0 = float(np.linalg.norm([a0 - true_a, c0 - true_c]))
    err = float(np.linalg.norm([a - true_a, c - true_c]))
    print(f"recovery: a {a:.4f} (truth {true_a}), c {c:.4f} (truth "
          f"{true_c}); err {err:.4f} vs err0 {err0:.4f} (bound 0.5 err0); "
          f"150 steps in {seconds:.2f} s", flush=True)
    if not err < 0.5 * err0:
        raise AssertionError(f"recovery failed: err {err}, err0 {err0}")


def _hmm_data(dev, num_timesteps, batch, seed, **model):
    """`hmm.make_model(**model)` on the card and observations from it."""
    comps = hmm.make_model(device=dev, **model)
    with torch.no_grad():
        _, obs = statistics.sample_from_prior(
            *comps[:3], num_timesteps, batch, NoiseSource.seeded(seed, dev))
    return comps, obs


def _hmm_exact(comps, obs):
    """The forward recursion's log-likelihood of each batch row."""
    initial, transition, emission, _ = comps
    args = (initial.logits.cpu().numpy(), transition.logits.cpu().numpy(),
            emission.locs.detach().cpu().numpy(), emission.scale)
    obs_np = obs.cpu().numpy()
    return np.array([hmm.hmm_forward(obs_np[:, b], *args)[1]
                     for b in range(obs_np.shape[1])])


@torch.no_grad()
def hmm_filter_phase(dev):
    phase(f"6 HMM filter: D={HMM_STATES}, fully adapted proposal, T={T}, "
          f"B={B}, K={K:,}")
    comps, obs = _hmm_data(dev, T, B, 0, num_states=HMM_STATES)

    def smc(seed, implementation="auto", method="systematic", **returns):
        return inference.infer(
            "smc", obs, *comps, K, noise=NoiseSource.seeded(seed, dev),
            resampling_method=method,
            resampling_implementation=implementation,
            return_log_marginal_likelihood=True, **returns)

    # The main path: log-Z only. The int32 particles take K5, and K1 runs
    # with no value columns for the indices K5 needs.
    reset_counts()
    out = smc(1, return_latents=False, return_log_weight=False)
    counts = read_counts("hmm filter")
    log_z = out["log_marginal_likelihood"]
    if (counts["resample_systematic"], counts["gather_sorted"]) != (T - 1,
                                                                    T - 1):
        raise AssertionError(f"the HMM log-Z call launched {counts}, not "
                             f"K1 and K5 {T - 1} times each")
    if log_z.shape != (B,) or not bool(torch.isfinite(log_z).all()):
        raise AssertionError(f"bad HMM log-Z {log_z}")
    print(f"log-Z-only call: K1 (indices only) and K5 {T - 1} launches "
          f"each, log-Z {log_z.cpu().numpy()}", flush=True)

    reset_counts()
    smc(1, method="stratified", return_latents=False,
        return_log_weight=False)
    counts = read_counts("hmm filter stratified")
    if (counts["searchsorted_sorted"], counts["gather_sorted"],
            counts["resample_sorted"]) != (T - 1, T - 1, 0):
        raise AssertionError(f"the stratified HMM call launched {counts}")

    # Lineage outputs, kernel route against plain route on the same noise.
    kern = smc(2, "cuda", return_ancestral_indices=True)
    plain = smc(2, "torch", return_ancestral_indices=True)
    lat, anc = kern["latents"], kern["ancestral_indices"]
    if lat.dtype != torch.int32 or lat.shape != (T, B, K):
        raise AssertionError(f"bad HMM latents {lat.dtype} {lat.shape}")
    same = (torch.equal(lat, plain["latents"]) and
            torch.equal(anc, plain["ancestral_indices"]) and
            torch.equal(kern["log_marginal_likelihood"],
                        plain["log_marginal_likelihood"]))
    if not same:
        raise AssertionError(
            f"HMM lineage call differs from the plain route: "
            f"{int((anc != plain['ancestral_indices']).sum())} ancestors, "
            f"{int((lat != plain['latents']).sum())} latents")
    print(f"lineage call: int32 latents {tuple(lat.shape)}, ancestors and "
          f"log-Z equal the plain route's exactly", flush=True)
    bench_dev = np.abs(kern["log_marginal_likelihood"].cpu().numpy() -
                       _hmm_exact(comps, obs))
    print(f"log-Z vs the forward recursion at the bench's shape "
          f"(systematic): per-row deviation {np.round(bench_dev, 4)}, max "
          f"{bench_dev.max():.4f}, mean {bench_dev.mean():.4f}", flush=True)

    # Accuracy at the JAX test's settings, multinomial, 8 noise seeds.
    tcomps, tobs = _hmm_data(dev, HMM_TEST_T, HMM_TEST_B, 7, **HMM_TEST)
    exact = _hmm_exact(tcomps, tobs)
    devs = np.array([np.abs(inference.infer(
        "smc", tobs, *tcomps, HMM_TEST_K,
        noise=NoiseSource.seeded(100 + seed, dev),
        resampling_method="multinomial", return_log_marginal_likelihood=True,
        return_latents=False)["log_marginal_likelihood"].cpu().numpy() -
        exact) for seed in range(HMM_SEEDS)])          # [seeds, B]
    print(f"log-Z vs the forward recursion, D=3 T={HMM_TEST_T} "
          f"B={HMM_TEST_B} K={HMM_TEST_K} multinomial, {HMM_SEEDS} seeds: "
          f"mean deviation per row {np.round(devs.mean(axis=0), 4)} (bound "
          f"{HMM_MEAN_TOL}), largest {devs.max():.4f} (bound "
          f"{HMM_MAX_TOL})", flush=True)
    if not (np.all(devs.mean(axis=0) < HMM_MEAN_TOL) and
            devs.max() < HMM_MAX_TOL):
        raise AssertionError(f"HMM log-Z off the forward recursion: {devs}")

    def filt(implementation):
        return lambda: smc(4, implementation, return_latents=False,
                           return_log_weight=False)

    torch.cuda.reset_peak_memory_stats()
    call_ms = {"torch": [], "cuda": []}
    for implementation in ("torch", "cuda", "cuda", "torch"):
        call_ms[implementation] += _cuda_ms(
            filt(implementation), warmup=2, repeat=5, each=True)
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    for implementation, label in (("cuda", "kernel route (K1 + K5)"),
                                  ("torch", "plain route")):
        q1, med, q3 = _quartiles(call_ms[implementation])
        print(f"HMM log-Z call, {label}: median {med:.3f} ms/call "
              f"(quartiles {q1:.3f}, {q3:.3f}; n="
              f"{len(call_ms[implementation])}) = "
              f"{B * K * T / med * 1e3:.4g} particle-steps/s", flush=True)
    print(f"peak device memory {peak_mb:.1f} MiB", flush=True)
    _profile(filt("cuda"), "one HMM filter call")


def hmm_train_phase(dev):
    """The JAX package's emission-learning test (tests/test_hmm.py:154-191)
    on the card: the means start off by (0.8, -0.6, 0.7); 120 Adam steps at
    lr 5e-2, K=256, the same noise at every step as the test fixes its
    key."""
    phase(f"7 HMM training: emission means, T={HMM_TEST_T}, B={HMM_TEST_B},"
          f" K=256, 120 Adam steps")
    comps, obs = _hmm_data(dev, HMM_TEST_T, HMM_TEST_B, 7, **HMM_TEST)
    initial, transition, true_emission, proposal = comps
    truth = true_emission.locs.detach().cpu().numpy()
    emission = hmm.Emission(truth + np.array([0.8, -0.6, 0.7]),
                            true_emission.scale).to(dev)
    optimizer = torch.optim.Adam(emission.parameters(), lr=5e-2)
    step = train.make_train_step(256, "aesmc", optimizer)
    components = (initial, transition, emission, proposal)
    reset_counts()
    first = float(step(components, obs, NoiseSource.seeded(0, dev)))
    counts = read_counts("hmm train step")
    if (counts["resample_systematic"], counts["gather_sorted"]) != (
            HMM_TEST_T - 1, HMM_TEST_T - 1):
        raise AssertionError(f"one HMM train step launched {counts}")
    start = time.perf_counter()
    for _ in range(119):
        loss = step(components, obs, NoiseSource.seeded(0, dev))
    last = float(loss)
    seconds = time.perf_counter() - start
    locs = emission.locs.detach().cpu().numpy()
    err = np.abs(np.sort(locs) - np.sort(truth))
    print(f"loss {first:.4f} -> {last:.4f} (must fall by more than 0.5); "
          f"locs {np.round(locs, 4)} vs truth {truth}: error max "
          f"{err.max():.4f} (bound 0.5), mean {err.mean():.4f} (bound "
          f"0.25); 119 steps in {seconds:.2f} s", flush=True)
    if not (last < first - 0.5 and err.max() < 0.5 and err.mean() < 0.25):
        raise AssertionError(f"HMM emission learning failed: loss {first} "
                             f"-> {last}, error {err}")


# ---- Slice A3: the graphed train step, graphed filters, ESS-adaptive
# resampling, the NaN guard and remat.

# Graphed train step (phase 8): steps and steps a block of the main run,
# and Adam's learning rate (bench.py:266).
GRAPH_STEPS, GRAPH_BLOCK = 600, 100
GRAPH_LR = 1e-2
# The graphed plain route's run, twice (before and after the main run).
GRAPH_PLAIN_STEPS, GRAPH_PLAIN_BLOCK = 300, 50
# Steps compared with eager `make_train_step` steps from the same seed:
# the losses must be bit-equal.
GRAPH_EQUAL_STEPS = 8
# Replays and eager calls a turn when timing the graphed filters.
FILTER_REPLAYS, FILTER_EAGER_CALLS = 20, 4

def _graph_learner(dev, lr):
    """The bench's training components (bench.py:261-280): the learner's
    transition from 0.5, emission and proposal trainable, Adam at ``lr``
    capturable; and the generative model the observations come from."""
    comps = (lgssm.Initial(0.0, 1.0),
             lgssm.Transition(0.5, TRANSITION_SCALE).to(dev),
             lgssm.Emission(EMISSION_MULT, EMISSION_SCALE).to(dev),
             lgssm.Proposal.create(
                 1.0, 1.0, torch.Generator().manual_seed(0)).to(dev))
    optimizer = torch.optim.Adam(train.get_chained_params(*comps), lr=lr,
                                 capturable=True)
    gen = (lgssm.Initial(0.0, 1.0),
           lgssm.Transition(TRANSITION_MULT, TRANSITION_SCALE).to(dev),
           lgssm.Emission(EMISSION_MULT, EMISSION_SCALE).to(dev))
    return comps, optimizer, gen


class _BlockTimer:
    """A `train_on_device` callback: a CUDA event at the end of each block
    (after the block's loss is read), and the block's mean loss."""

    def __init__(self):
        self.events, self.steps, self.losses = [], [], []

    def __call__(self, done, mean_loss, components):
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        self.events.append(event)
        self.steps.append(done)
        self.losses.append(mean_loss)

    def ms_per_step(self, first=1):
        """ms a step of every block from block ``first`` on (0-based; the
        blocks before it hold the warm-up and the capture)."""
        torch.cuda.synchronize()
        return [self.events[i - 1].elapsed_time(self.events[i]) /
                (self.steps[i] - self.steps[i - 1])
                for i in range(first, len(self.events))]


def _on_device(dev, num_steps, block, k=None, lr=None, seed=21,
               callback=None, **kwargs):
    """`train.train_on_device` on the bench's LGSSM at (T, B) = (200, 10),
    K = ``k`` (default `TRAIN_K`) and Adam at ``lr`` (default
    `GRAPH_LR`); returns (components, losses)."""
    comps, optimizer, gen = _graph_learner(
        dev, GRAPH_LR if lr is None else lr)
    return train.train_on_device(
        *comps, k or TRAIN_K, "aesmc", gen, T, B, num_steps,
        optimizer=optimizer,
        noise=NoiseSource.seeded(seed, dev), steps_per_call=block,
        callback=callback, **kwargs)


def _eager_steps(dev, num_steps, seed=21):
    """``num_steps`` eager `make_train_step` steps, each on observations
    sampled from the generative model through the same noise source, as
    `train_on_device` draws them; returns the losses."""
    comps, optimizer, gen = _graph_learner(dev, GRAPH_LR)
    noise = NoiseSource.seeded(seed, dev)
    step = train.make_train_step(TRAIN_K, "aesmc", optimizer)
    losses_ = []
    for _ in range(num_steps):
        with torch.no_grad():
            _, obs = statistics.sample_from_prior(*gen, T, B, noise)
        losses_.append(step(comps, obs, noise))
    return torch.stack(losses_)


def _kernel_events(prof):
    """{profiler kernel name: launches} for the port's kernels, and the
    device time of every kernel, copy and fill, in ms."""
    from torch.autograd import DeviceType
    events = prof.key_averages()
    counts = {name: sum(e.count for e in events if name in e.key)
              for name in sorted({n for _, _, n, _ in KERNELS.values()})}
    on_card = [e for e in events
               if getattr(e, "device_type", None) == DeviceType.CUDA]
    device_us = sum(getattr(e, "device_time_total",
                            getattr(e, "cuda_time_total", 0.0))
                    for e in on_card)
    print(f"{sum(e.count for e in on_card)} kernels, copies and fills on the"
          f" card", flush=True)
    launch = [e for e in events if e.key == "cudaGraphLaunch"]
    if launch:
        print(f"cudaGraphLaunch: {launch[0].count} calls, "
              f"{launch[0].cpu_time_total / launch[0].count / 1e3:.3f} ms "
              f"of host time each", flush=True)
    return counts, device_us / 1e3


def _report_profile(prof, label, want, span_ms, wall_ms):
    """Prints the device time of one profiled replay by kernel, checks the
    port's kernels' launches against ``want`` ({profiler name:
    launches}) and prints the idle share: against ``span_ms``, the CUDA
    events' span around the same profiled replay, and against
    ``wall_ms``, the median of runs without the profiler. Both ratios are
    printed unclamped; a negative one means the busy time read by the
    profiler exceeds that span."""
    counts, device_ms = _kernel_events(prof)
    print(f"profile of one replay, {label}: device time {device_ms:.3f} ms;"
          f" the port's kernels {counts}", flush=True)
    print(prof.key_averages().table(sort_by="cuda_time_total",
                                    row_limit=12), flush=True)
    for name, n in want.items():
        if counts[name] != n:
            raise AssertionError(f"{label}: {counts[name]} {name} events in "
                                 f"one replay, not {n}")
    print(f"{label}: device busy {device_ms:.3f} ms in a profiled replay "
          f"whose CUDA events span {span_ms:.3f} ms: idle share "
          f"{1 - device_ms / span_ms:.2%} (same run); against the median "
          f"{wall_ms:.3f} ms of replays without the profiler "
          f"{1 - device_ms / wall_ms:.2%}", flush=True)
    return counts, device_ms


def _profile_replay(run, label, want, wall_ms):
    """Runs ``run`` (one replay) under torch.profiler between two CUDA
    events and reports it (`_report_profile`)."""
    from torch.profiler import ProfilerActivity, profile
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start.record()
        run()
        end.record()
        torch.cuda.synchronize()
    return _report_profile(prof, label, want, start.elapsed_time(end),
                           wall_ms)


def _profiled_train_replay(dev, label, want, wall_ms, **kwargs):
    """One replay of `train_on_device`'s graph under the profiler: the
    first block is the warm-up, the capture and its first replay; the
    profiler and a CUDA event start in its callback, and the second
    block, one more replay, ends at a second event in the next callback
    (after the block's loss is read)."""
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    events = []

    def mark(done, mean_loss, components):
        if not events:
            torch.cuda.synchronize()
            prof.start()
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()

    _on_device(dev, train.WARMUP_STEPS + 2, train.WARMUP_STEPS + 1,
               callback=mark, **kwargs)
    torch.cuda.synchronize()
    prof.stop()
    return _report_profile(prof, f"train step, {label}", want,
                           events[0].elapsed_time(events[1]), wall_ms)


def graph_train_phase(dev):
    phase(f"8 graphed train step: train_on_device, T={T}, B={B}, "
          f"K={TRAIN_K}, {GRAPH_STEPS} steps in blocks of {GRAPH_BLOCK}")
    # The first steps against eager steps from the same seed and Adam.
    _, graphed = _on_device(dev, GRAPH_EQUAL_STEPS, GRAPH_EQUAL_STEPS)
    eager = _eager_steps(dev, GRAPH_EQUAL_STEPS)
    exact = torch.equal(graphed, eager)
    print(f"first {GRAPH_EQUAL_STEPS} steps ({train.WARMUP_STEPS} warm-up, "
          f"{GRAPH_EQUAL_STEPS - train.WARMUP_STEPS} replays) against eager "
          f"make_train_step steps from the same seed: bit-equal {exact}; "
          f"losses {graphed.cpu().numpy()}", flush=True)
    if not exact:
        raise AssertionError(f"graphed losses differ from eager: "
                             f"{graphed} vs {eager}")

    # Fresh noise at every replay: with lr 0 the parameters stay, so the
    # replays' losses differ only by their noise.
    _, frozen = _on_device(dev, train.WARMUP_STEPS + 3, 10, lr=0.0)
    replays = frozen[train.WARMUP_STEPS:].cpu().tolist()
    print(f"lr 0: the replays' losses {replays}", flush=True)
    if len(set(replays)) != len(replays):
        raise AssertionError(f"two replays drew the same noise: {replays}")

    # The plain route graphed, then the kernel route (the main path),
    # then the plain route again.
    timers = {"torch": _BlockTimer(), "cuda": _BlockTimer()}
    _on_device(dev, GRAPH_PLAIN_STEPS, GRAPH_PLAIN_BLOCK,
               callback=timers["torch"], resampling_implementation="torch")
    reset_counts()
    comps, hist = _on_device(dev, GRAPH_STEPS, GRAPH_BLOCK,
                             callback=timers["cuda"])
    counts = read_counts("graphed train K=100")
    plain_again = _BlockTimer()
    _on_device(dev, GRAPH_PLAIN_STEPS, GRAPH_PLAIN_BLOCK,
               callback=plain_again, resampling_implementation="torch")
    # The wrappers count at the warm-up steps and the capture; replays
    # launch from the graph.
    captured = (train.WARMUP_STEPS + 1) * (T - 1)
    if (counts["resample_systematic"], counts["range_sum"]) != (captured,
                                                                captured):
        raise AssertionError(f"train_on_device launched {counts} through "
                             f"the wrappers, not K1 and K2 {captured} times")
    ms = {"cuda": timers["cuda"].ms_per_step(),
          "torch": timers["torch"].ms_per_step() +
          plain_again.ms_per_step()}
    for impl, label in (("cuda", "kernel route"), ("torch", "plain route")):
        q1, med, q3 = _quartiles(ms[impl])
        EAGER_MS[f"graphed train {impl}"] = med
        print(f"graphed AESMC train step K={TRAIN_K}, {label}: median "
              f"{med:.3f} ms/step (quartiles {q1:.3f}, {q3:.3f}; blocks "
              f"{np.round(ms[impl], 3).tolist()}) = {1e3 / med:.2f} "
              f"steps/s; eager make_train_step "
              f"{EAGER_MS.get(f'train {impl}', float('nan')):.3f} ms/step "
              f"(phase 5)", flush=True)
    mult = comps[1].mult.item()
    first, last = float(hist[:30].mean()), float(hist[-30:].mean())
    print(f"learning: transition {mult:.4f} (truth {TRANSITION_MULT}, "
          f"bound 0.45), mean loss of the first 30 steps {first:.4f}, of "
          f"the last 30 {last:.4f}", flush=True)
    if not (abs(mult - TRANSITION_MULT) < 0.45 and last < first and
            bool(torch.isfinite(hist).all())):
        raise AssertionError(f"train_on_device did not learn: {mult}, "
                             f"{first} -> {last}")

    for impl, label in (("cuda", "kernel route"), ("torch", "plain route")):
        n = T - 1 if impl == "cuda" else 0
        _profiled_train_replay(
            dev, label,
            {"resample_systematic_kernel": n, "range_sum_kernel": n},
            EAGER_MS[f"graphed train {impl}"],
            resampling_implementation=impl)

    # The filter's width: graphed steps at K=10,000, with and without
    # remat, and peak memory. Blocks of 3 steps: the warm-up, the capture
    # with two replays, then two blocks of three replays, timed.
    block = train.WARMUP_STEPS
    for remat in (False, True):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        big = _BlockTimer()
        _on_device(dev, 4 * block, block, k=K, callback=big, remat=remat)
        peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
        print(f"graphed AESMC train step K={K}{', remat' if remat else ''}:"
              f" {np.round(big.ms_per_step(first=2), 3).tolist()} ms/step "
              f"(eager {EAGER_MS.get('train K=10000', float('nan')):.3f}); "
              f"peak device memory {peak_mb:.1f} MiB (eager step "
              f"{EAGER_MS.get('peak K=10000', float('nan')):.1f} MiB)",
              flush=True)


def _graphed_filter(dev, label, call, noise, want):
    """Captures one filter call (``call`` returns its log-Z), checks a
    replay against an eager call from the same generator state, times
    replays against eager calls in turns, and profiles one replay."""
    with torch.no_grad():
        train._warm_up(call, 1)
        reset_counts()
        graph, log_z = train._capture(call, noise.generator)
        read_counts(f"graphed {label} (capture)")
        state = noise.generator.get_state()
        graph.replay()
        replayed = log_z.clone()
        graph.replay()
        second = log_z.clone()
        noise.generator.set_state(state)
        eager = call()
        print(f"graphed {label}: replay log-Z {replayed.cpu().numpy()}; "
              f"equal to an eager call from the same generator state "
              f"{torch.equal(replayed, eager)}; the next replay differs "
              f"{not torch.equal(replayed, second)}", flush=True)
        if not torch.equal(replayed, eager):
            raise AssertionError(f"graphed {label} differs from eager: "
                                 f"{replayed} vs {eager}")
        if torch.equal(replayed, second):
            raise AssertionError(f"two replays of {label} drew the same "
                                 f"noise")
        runs = {"eager": [], "graph": []}
        for which in ("eager", "graph", "graph", "eager"):
            fn, n = ((call, FILTER_EAGER_CALLS) if which == "eager" else
                     (graph.replay, FILTER_REPLAYS))
            runs[which] += _cuda_ms(fn, warmup=1, repeat=n, each=True)
        out = {}
        for which in ("graph", "eager"):
            q1, med, q3 = _quartiles(runs[which])
            out[which] = med
            print(f"{label}, {which}: median {med:.3f} ms/call (quartiles "
                  f"{q1:.3f}, {q3:.3f}; n={len(runs[which])}) = "
                  f"{B * K * T / med * 1e3:.4g} particle-steps/s",
                  flush=True)
        _profile_replay(graph.replay, label, want, out["graph"])


def graph_filter_phase(dev):
    phase(f"9 graphed filters: one infer call captured, LGSSM at (T, B, K) "
          f"= ({T}, {B}, {K:,}), HMM with D={HMM_STATES}")
    comps, obs = _bench_lgssm(dev, TRANSITION_MULT)
    noise = NoiseSource.seeded(31, dev)

    def lgssm_call():
        return inference.infer(
            "smc", obs, *comps, K, noise=noise,
            return_log_marginal_likelihood=True, return_latents=False,
            return_log_weight=False)["log_marginal_likelihood"]

    _graphed_filter(dev, "LGSSM filter", lgssm_call, noise,
                    {"resample_systematic_kernel": T - 1})
    hcomps, hobs = _hmm_data(dev, T, B, 0, num_states=HMM_STATES)
    hnoise = NoiseSource.seeded(32, dev)

    def hmm_call():
        return inference.infer(
            "smc", hobs, *hcomps, K, noise=hnoise,
            return_log_marginal_likelihood=True, return_latents=False,
            return_log_weight=False)["log_marginal_likelihood"]

    _graphed_filter(dev, "HMM filter", hmm_call, hnoise,
                    {"resample_systematic_kernel": T - 1,
                     "gather_sorted_kernel": T - 1})


class _NanEmission:
    """The bench's emission with a NaN scale from time step 2 on."""

    def __call__(self, latents=None, time=None, previous_observations=None):
        scale = float("nan") if time >= 2 else EMISSION_SCALE
        return distributions.Normal(
            latents[-1], scale,
            batch_shape_mode=BatchShapeMode.FULLY_EXPANDED)


def adaptive_phase(dev):
    phase(f"10 ESS-adaptive resampling, the NaN guard and remat, T={T}, "
          f"B={B}")
    # The adaptive filter at K=10,000 against the Kalman filter.
    comps, obs = _bench_lgssm(dev, TRANSITION_MULT)
    optimal = lgssm.optimal_proposal(
        0.0, 1.0, TRANSITION_MULT, TRANSITION_SCALE, EMISSION_MULT,
        EMISSION_SCALE).to(dev)
    reset_counts()
    with torch.no_grad():
        out = inference.infer(
            "smc", obs, *comps[:3], optimal, K,
            noise=NoiseSource.seeded(41, dev), resampling_criterion=0.5,
            return_log_marginal_likelihood=True, return_latents=False,
            return_ancestral_indices=True)
    counts = read_counts("adaptive filter")
    if counts["resample_systematic"] != T - 1:
        raise AssertionError(f"the adaptive filter launched {counts}")
    anc = out["ancestral_indices"]
    kept = (anc == torch.arange(K, device=dev)).all(dim=-1)
    params = kalman.KalmanParams(
        initial_mean=0.0, initial_variance=1.0,
        transition_mult=TRANSITION_MULT, transition_offset=0.0,
        transition_variance=TRANSITION_SCALE ** 2,
        emission_mult=EMISSION_MULT, emission_offset=0.0,
        emission_variance=EMISSION_SCALE ** 2)
    obs_np = obs.cpu().numpy()
    exact = np.array([kalman.kalman_filter(obs_np[:, b], params)[4]
                      for b in range(B)])
    rel = np.abs(out["log_marginal_likelihood"].cpu().numpy() - exact) / \
        np.abs(exact)
    print(f"adaptive filter (frac 0.5) at K={K:,}: {T - 1} K1 launches; "
          f"{int((~kept).sum())} of {kept.numel()} row-steps resampled; "
          f"log-Z vs Kalman: max relative error {rel.max():.3e} (bound "
          f"{LOG_Z_REL_TOL})", flush=True)
    if not np.all(rel < LOG_Z_REL_TOL):
        raise AssertionError(f"adaptive log-Z off the Kalman filter: {rel}")

    # One adaptive train step at K=100: K1 forward, K2 backward.
    tcomps, tobs = _bench_lgssm(dev, 0.5)
    optimizer = torch.optim.Adam(train.get_chained_params(*tcomps), lr=1e-2)
    step = train.make_train_step(TRAIN_K, "aesmc", optimizer,
                                 resampling_criterion=0.5)
    reset_counts()
    loss = step(tcomps, tobs, NoiseSource.seeded(42, dev))
    counts = read_counts("adaptive train K=100")
    if (counts["resample_systematic"], counts["range_sum"]) != (T - 1,
                                                                T - 1):
        raise AssertionError(f"the adaptive step launched {counts}")
    if not bool(torch.isfinite(loss)):
        raise AssertionError(f"adaptive step loss {loss}")
    print(f"adaptive train step K={TRAIN_K}: loss {float(loss):.4f}, K1 and "
          f"K2 {T - 1} launches each", flush=True)

    # The NaN guard: a NaN step raises before the optimizer step.
    step = train.make_train_step(TRAIN_K, "aesmc", optimizer,
                                 nan_check=True)
    step(tcomps, tobs, NoiseSource.seeded(43, dev))
    params = [p.detach().clone() for p in train.get_chained_params(*tcomps)]
    adam = [{k: v.clone() for k, v in s.items()}
            for s in optimizer.state.values()]
    nan_comps = (tcomps[0], tcomps[1], _NanEmission(), tcomps[3])
    try:
        step(nan_comps, tobs, NoiseSource.seeded(44, dev))
    except FloatingPointError as err:
        print(f"NaN step raised FloatingPointError: {err}", flush=True)
    else:
        raise AssertionError("a NaN step did not raise")
    same = all(torch.equal(a, p) for a, p in
               zip(params, train.get_chained_params(*tcomps)))
    same_adam = all(torch.equal(v, s[k]) for a, s in
                    zip(adam, optimizer.state.values())
                    for k, v in a.items())
    print(f"after the NaN step: parameters bit-identical {same}, Adam "
          f"state bit-identical {same_adam}", flush=True)
    if not (same and same_adam):
        raise AssertionError("the NaN step changed the parameters or Adam")

    # remat at the filter's width: loss and gradients against the plain
    # step, and both peak memories.
    rcomps, robs = _bench_lgssm(dev, 0.5)
    params = train.get_chained_params(*rcomps)
    results = {}
    for remat in (False, True):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        loss = losses.get_loss(robs, K, "aesmc", *rcomps,
                               noise=NoiseSource.seeded(45, dev),
                               remat=remat)
        grads = torch.autograd.grad(loss, params)
        counts = read_counts(f"{'remat' if remat else 'plain'} loss+grad "
                             f"K={K}")
        results[remat] = (loss.detach(), grads,
                          torch.cuda.max_memory_allocated() / 2 ** 20,
                          counts)
    (loss_p, grads_p, peak_p, _), (loss_r, grads_r, peak_r, counts_r) = \
        results[False], results[True]
    worst = max(float((a - b).abs().max() / b.abs().max())
                for a, b in zip(grads_r, grads_p))
    k1, k2 = counts_r["resample_systematic"], counts_r["range_sum"]
    print(f"remat at K={K:,}: loss {float(loss_r):.6f}, equal to the plain "
          f"step's {torch.equal(loss_r, loss_p)}; gradients within relative "
          f"error {worst:.3g} (bound {GRAD_RTOL}); K1 {k1} launches "
          f"(forward and recompute), K2 {k2}; peak device memory "
          f"{peak_r:.1f} MiB "
          f"with remat, {peak_p:.1f} MiB without (766.9 MiB: eager "
          f"train step, PERF.md section 2)", flush=True)
    if not torch.equal(loss_r, loss_p) or worst > GRAD_RTOL:
        raise AssertionError(f"remat differs: loss {loss_r} vs {loss_p}, "
                             f"gradients {worst}")


def _build_other(other, sources):
    """Builds each of ``sources`` from directory ``other`` with `_build`'s
    flags, one nvcc each, all started together, into `compare/` of the
    build directory; returns {source: its library}."""
    out = _build.build_dir() / "compare"
    out.mkdir(parents=True, exist_ok=True)

    def build(source):
        lib = out / f"lib{pathlib.Path(source).stem}.so"
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib),
               str(other / source)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed building {other / source}:\n"
                               f"{proc.stdout}{proc.stderr}")
        return ctypes.CDLL(str(lib))

    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        return dict(zip(sources, pool.map(build, sources)))


@contextlib.contextmanager
def _launching(entries):
    """The wrappers launch ``entries`` ({(source, symbol): C entry}) in
    place of the entries `_launch.entry` bound for them (K4's wrapper
    keeps its entry in its module as well)."""
    k4 = searchsorted_sorted_cuda
    saved, saved_k4 = dict(_launch._entries), k4._entry
    _launch._entries.update(entries)
    k4._entry = _launch._entries[(k4.SOURCE, k4._SYMBOL)]
    try:
        yield
    finally:
        _launch._entries.update(saved)
        k4._entry = saved_k4


def compare_phase(dev, other):
    """Each kernel's device time against another version of it, built from
    the sources in ``other`` (files named as in `aesmc_tpu_torch/csrc/`,
    with the same C entries), on the same inputs, in turns (other, this,
    this, other, twice). The other version is launched through this
    version's wrappers: its C entries are bound with the argument types
    that the wrappers bound for their own."""
    phase(f"3 compare: each kernel against the version in {other}")
    generator = torch.Generator(device=dev).manual_seed(11)
    cdf, u, value = _case_inputs(B, K, 1, "normal", generator, dev)
    pos = resampling.resampling_positions(cdf, NoiseSource(generator),
                                          "stratified")
    g = torch.randn(B, K, 1, generator=generator, device=dev)
    cases = [
        ("K1 (10, 10000, 1)", "resample_systematic", lambda: (
            resample_cuda.resample_and_gather_systematic(cdf, u, value))),
        ("K1 (10, 10000, 0) indices", "resample_systematic", lambda: (
            resample_cuda.resample_and_gather_systematic(
                cdf, u, value.new_empty((B, K, 0)), True))),
        ("K2 (10, 10000, 1)", "range_sum", lambda: range_sum_cuda.range_sum(
            cdf, pos, g)),
        ("K3 (10, 10000, 1)", "resample_sorted", lambda: (
            resample_sorted_cuda.resample_and_gather_sorted(cdf, pos,
                                                            value))),
        ("K4 (10, 10000)", "searchsorted_sorted", lambda: (
            searchsorted_sorted_cuda.searchsorted_sorted(cdf, pos))),
    ]
    for batch, k, d in K5_TIMES:
        logw = torch.randn(batch, k, generator=generator, device=dev) * 3.0
        idx = resampling.sample_ancestral_index(logw, NoiseSource(generator))
        shape = (batch, k) if d == 1 else (batch, k, d)
        latents = _k5_value(torch.int32, shape, generator, dev)
        cases.append((f"K5 {(batch, k, d)} int32", "gather_sorted",
                      lambda latents=latents, idx=idx: (
                          gather_sorted_cuda.gather_sorted(latents, idx))))
    for batch, k, kind in K6_TIMES:
        logw, p6, v6 = _k6_inputs(batch, k, kind, generator, dev)
        cases.append((f"K6 {(batch, k, 1)} {kind}", "searchsorted_cdf",
                      lambda logw=logw, p6=p6, v6=v6: (
                          searchsorted_cdf_cuda.searchsorted_cdf(logw, p6,
                                                                 v6))))
    for _, _, fn in cases:
        fn()        # binds this version's C entries
    torch.cuda.synchronize()
    libs = _build_other(other, sorted({key[0] for key in _launch._entries}))
    entries = {}
    for (source, symbol), fn in _launch._entries.items():
        entries[(source, symbol)] = getattr(libs[source], symbol)
        entries[(source, symbol)].argtypes = fn.argtypes
        entries[(source, symbol)].restype = fn.restype
    # K5's int32 rows go to the other version as 4-byte elements, which
    # every version takes (the wrapper may hand them over as 16-byte ones).
    k5 = (gather_sorted_cuda.SOURCE, "aesmc_gather_sorted")
    raw = entries[k5]
    entries[k5] = lambda value, idx, out, batch, k, kp, d, unit, *rest: raw(
        value, idx, out, batch, k, kp, d * unit // 4, 4, *rest)
    for label, name, fn in cases:
        runs = {"this": [], "other": []}
        calls = 10 if "4194304" in label else 50
        for which in ("other", "this", "this", "other") * 2:
            with (_launching(entries) if which == "other" else
                  contextlib.nullcontext()):
                ms = _device_ms(fn, KERNELS[name][2], calls)
            runs[which].append(None if ms is None else round(ms * 1e3, 3))
        print(f"compare {label}: device us a launch, this version "
              f"{runs['this']}, the other {runs['other']}", flush=True)


def main():
    parser = argparse.ArgumentParser(
        description="Smoke test of the PyTorch port on one NVIDIA GPU.")
    parser.add_argument(
        "--compare", type=pathlib.Path, metavar="DIR",
        help="after phases 1 and 2, time each kernel against the version "
             "whose sources are in DIR instead of driving the paths")
    args = parser.parse_args()
    dev = device_phase()
    build_phase()
    if args.compare is not None:
        compare_phase(dev, args.compare)
        return
    errors = {"resample_systematic": k1_phase(dev),
              "range_sum": k2_phase(dev),
              "resample_sorted": k3_phase(dev)}
    times = kernel_times(dev)
    host_costs(dev)
    times["gather_sorted"] = k5_phase(dev)
    errors["gather_sorted"] = 0.0
    times["searchsorted_sorted"] = k4_phase(dev)
    errors["searchsorted_sorted"] = 0.0
    times["searchsorted_cdf"] = k6_phase(dev)
    errors["searchsorted_cdf"] = 0.0
    rows_phase(dev)
    filter_phase(dev)
    train_phase(dev)
    hmm_filter_phase(dev)
    hmm_train_phase(dev)
    graph_train_phase(dev)
    graph_filter_phase(dev)
    adaptive_phase(dev)
    kernels = []
    for name, (module, _, _, replaces) in KERNELS.items():
        launches = sum(LAUNCHES[name].values())
        if not launches:
            raise AssertionError(f"{name} was never launched on a main path")
        kernels.append(dict(
            name=name, route="cuda",
            source=f"aesmc_tpu_torch/csrc/{module.SOURCE}",
            replaces=replaces, launches=launches,
            launches_by_path=LAUNCHES[name], max_abs_err=errors[name],
            **times[name]))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
