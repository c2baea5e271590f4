#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU.

Run from the root of the repository, on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, in order; any failure raises and the exit code is not 0:

1. device: a CUDA card must be present (there is no CPU path); prints
   `nvidia-smi`'s name and power limit of the card;
2. build: builds the three CUDA kernels of the port's paths from
   `aesmc_tpu_torch/csrc/`, one nvcc each, all started together;
3. kernels against their plain PyTorch versions on the same inputs on the
   card, at the main paths' shapes, at other shapes up to K = 8,388,608
   and at degenerate weights:
   - K1, the fused systematic resample+gather: exactly equal (indices and
     gathered values), index output on and off;
   - K2, the range sum (the backward of K1 and K3): exactly equal with
     integer cotangents in [-5, 5] (every sum is then exact in float32),
     within 1e-5 x the largest segment's sum of |g| with float
     cotangents, and the same bits on two launches;
   - K3, the search + gather over loaded sorted positions: exactly equal
     on stratified, multinomial and Kp != K positions;
   each is timed against its plain version (CUDA events; plain, kernel,
   kernel, plain) and its device time read from torch.profiler;
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
   `train.train` that must halve the parameters' distance to the truth.

It prints a `{"kernels": [...]}` JSON line before the last, and, as the
last line, `{"ok": true, "device": {...}}`. It imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import subprocess
import time

import numpy as np
import torch

from aesmc_tpu_torch import inference, losses, resampling, statistics, train
from aesmc_tpu_torch.models import kalman, lgssm
from aesmc_tpu_torch.noise import NoiseSource
from aesmc_tpu_torch.ops import (_build, range_sum_cuda, resample_cuda,
                                 resample_sorted_cuda)

T, B, K = 200, 10, 10000
# The reference training shape (bench.py:264).
TRAIN_K = 100
# The bench's LGSSM (bench.py): x_0 ~ N(0, 1), x_t = 0.9 x_{t-1} + N(0, 1),
# y_t = x_t + N(0, 0.2^2).
TRANSITION_MULT, TRANSITION_SCALE = 0.9, 1.0
EMISSION_MULT, EMISSION_SCALE = 1.0, 0.2
# The repo's Kalman-oracle bound on log-Z (tests/test_inference.py).
LOG_Z_REL_TOL = 0.05
# K2 with float cotangents: max abs error against the plain version
# within this fraction of the largest segment's sum of |g| (the two add
# in different orders; the plain version's scatter_add uses atomics).
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

KERNELS = {
    "resample_systematic": (resample_cuda, "resample_systematic_kernel",
                            "aesmc_tpu/ops/resample_pallas.py:385"),
    "range_sum": (range_sum_cuda, "range_sum_kernel",
                  "aesmc_tpu/ops/resample_pallas.py:961"),
    "resample_sorted": (resample_sorted_cuda, "resample_sorted_kernel",
                        "aesmc_tpu/ops/resample_pallas.py:945"),
}

# Kernel launches on each main path, read from the wrappers' counts.
LAUNCHES = {name: {} for name in KERNELS}


def phase(name):
    print(f"== {name}", flush=True)


def reset_counts():
    for module, _, _ in KERNELS.values():
        module.LAUNCHES = 0


def read_counts(path):
    """Records each kernel's launches on ``path`` since `reset_counts`."""
    torch.cuda.synchronize()
    counts = {name: module.LAUNCHES
              for name, (module, _, _) in KERNELS.items()}
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
    sources = [module.SOURCE for module, _, _ in KERNELS.values()]
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
    if kind == "one_particle":
        # All mass on one particle per row.
        hot = torch.randint(0, k, (batch,), generator=generator, device=dev)
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


CASES = [(10, 10000, 1, "normal"), (3, 1000, 3, "normal"),
         (1, 1, 1, "normal"), (2, 1025, 1, "normal"),
         (1, 8388608, 1, "normal"), (3, 1000, 2, "one_particle"),
         (3, 1000, 2, "neg_inf")]


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
    stratified and multinomial positions, and two cases with Kp != K."""
    for batch, k, d, kind in CASES:
        cdf, u, value = _case_inputs(batch, k, d, kind, generator, dev)
        yield ((batch, k, k, d), kind, "systematic", cdf,
               resample_cuda.systematic_positions(u, k), value)
        noise = NoiseSource(generator)
        for method in ("stratified", "multinomial"):
            pos = resampling.resampling_positions(cdf, noise, method)
            yield (batch, k, k, d), kind, method, cdf, pos, value
    for batch, k, kp, d in ((2, 2048, 512, 1), (2, 512, 2048, 2)):
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
        bound = RANGE_SUM_REL_TOL * float(
            range_sum_cuda.range_sum_torch(cdf, pos, g.abs()).max())
        err = float((got - want).abs().max())
        worst = max(worst, err)
        if err > bound:
            raise AssertionError(
                f"K2 with float cotangents at {shape} {kind} {method}: max "
                f"abs error {err} above the bound {bound}")
        if not torch.equal(_bits(got), _bits(again)):
            raise AssertionError(f"K2 gave other bits on a second launch "
                                 f"at {shape} {kind} {method}")
        print(f"(B, K, Kp, D) = {shape} {kind:12s} {method:11s}: integer "
              f"cotangents exact, float max abs error {err:.3g} (bound "
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


def _time_pair(kernel_fn, plain_fn, warmup=20, repeat=200):
    """(kernel ms, plain ms, runs): CUDA-event means in the order plain,
    kernel, kernel, plain."""
    runs = {"kernel": [], "plain": []}
    for which in ("plain", "kernel", "kernel", "plain"):
        fn = kernel_fn if which == "kernel" else plain_fn
        runs[which].append(_cuda_ms(fn, warmup, repeat))
    return float(np.mean(runs["kernel"])), float(np.mean(runs["plain"])), runs


def _bound(nbytes, ops):
    """(bound ms, what bounds it) for moving ``nbytes`` and doing ``ops``
    float32 operations on the card."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / FP32_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                          "operations")


def _search_steps(n):
    return math.ceil(math.log2(n + 1))


def kernel_times(dev):
    """Times K1, K2 and K3 at the filter's shape (B=10, K=10,000, D=1) and
    the training shape (K=100), each against its plain version; returns
    the JSON fields of each kernel at (10, 10,000, 1)."""
    phase("3d kernel times against their plain versions")
    out = {}
    for k in (K, TRAIN_K):
        generator = torch.Generator(device=dev).manual_seed(5)
        cdf, u, value = _case_inputs(B, k, 1, "normal", generator, dev)
        pos = resampling.resampling_positions(cdf, NoiseSource(generator),
                                              "stratified")
        g = torch.randn(B, k, 1, generator=generator, device=dev)
        one_cdf, one_u, _ = _case_inputs(B, k, 1, "one_particle", generator,
                                         dev)
        one_pos = resample_cuda.systematic_positions(one_u, k)
        sys_pos = resample_cuda.systematic_positions(u, k)
        n, f = B * k, 4
        steps = _search_steps(k)
        cases = {
            "resample_systematic": (
                lambda: resample_cuda.resample_and_gather_systematic(
                    cdf, u, value, False),
                lambda: resample_cuda.resample_and_gather_systematic_torch(
                    cdf, u, value, False),
                f * (n + B + 2 * n), n * steps),
            "range_sum": (
                lambda: range_sum_cuda.range_sum(cdf, sys_pos, g),
                lambda: range_sum_cuda.range_sum_torch(cdf, sys_pos, g),
                f * 4 * n, 2 * n * steps + n),
            "resample_sorted": (
                lambda: resample_sorted_cuda.resample_and_gather_sorted(
                    cdf, pos, value, False),
                lambda: resample_sorted_cuda.resample_and_gather_sorted_torch(
                    cdf, pos, value, False),
                f * 4 * n, n * steps),
        }
        for name, (kernel_fn, plain_fn, nbytes, ops) in cases.items():
            ms, plain_ms, runs = _time_pair(kernel_fn, plain_fn)
            device_ms = _device_ms(kernel_fn, KERNELS[name][1])
            bound_ms, bound_by = _bound(nbytes, ops)
            print(f"{name} at (B, K, D) = ({B}, {k}, 1): {ms * 1e3:.2f} "
                  f"us/call through the wrapper (runs {runs['kernel']}), "
                  f"device {'not measured' if device_ms is None else f'{device_ms * 1e3:.2f} us'}"
                  f" a launch, plain {plain_ms * 1e3:.2f} us/call (runs "
                  f"{runs['plain']}); bound {bound_ms * 1e3:.3f} us "
                  f"({bound_by}: {nbytes} bytes, {ops} operations)",
                  flush=True)
            if k == K:
                out[name] = dict(ms=ms, plain_ms=plain_ms,
                                 device_ms=device_ms, bound_ms=bound_ms,
                                 bound_by=bound_by, library_ms=None,
                                 shape=[B, k, k, 1])
        # K2's weak case: a row whose mass sits on one source, which one
        # thread then sums alone.
        one_g = torch.randn(B, k, 1, generator=generator, device=dev)
        ms = _cuda_ms(lambda: range_sum_cuda.range_sum(one_cdf, one_pos,
                                                       one_g), 5, 50)
        device_ms = _device_ms(
            lambda: range_sum_cuda.range_sum(one_cdf, one_pos, one_g),
            KERNELS["range_sum"][1], calls=10)
        print(f"range_sum at ({B}, {k}, 1), all mass on one particle a row:"
              f" {ms * 1e3:.2f} us/call, device "
              f"{'not measured' if device_ms is None else f'{device_ms * 1e3:.2f} us'}"
              f" a launch", flush=True)
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
    ms, plain_ms, runs = _time_pair(
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
    print(prof.key_averages().table(sort_by="cuda_time_total",
                                    row_limit=25), flush=True)


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


def main():
    dev = device_phase()
    build_phase()
    errors = {"resample_systematic": k1_phase(dev),
              "range_sum": k2_phase(dev),
              "resample_sorted": k3_phase(dev)}
    times = kernel_times(dev)
    host_costs(dev)
    filter_phase(dev)
    train_phase(dev)
    kernels = []
    for name, (module, _, replaces) in KERNELS.items():
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
