#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU.

Run from the root of the repository, on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, in order; any failure raises and the exit code is not 0:

1. device: a CUDA card must be present (there is no CPU path); prints
   `nvidia-smi`'s name and power limit of the card;
2. build: builds the CUDA kernels of the main path from
   `aesmc_tpu_torch/csrc/`;
3. kernel: the fused systematic resample+gather kernel (K1) against its
   plain PyTorch version on the same inputs on the card, exactly equal
   (indices and gathered values), with the index output on and off, at the
   main path's shape, at other shapes up to K = 8,388,608, and at
   degenerate weights;
4. slice: the LGSSM SMC filter at the bench's shape (T=200, B=10,
   K=10,000) through `inference.infer`: the log-Z-only call launches K1
   T-1 times; the lineage call agrees exactly with the plain route; with
   the optimal proposal log-Z lies within 5% of the Kalman filter; times
   the filter and K1 against their plain versions with CUDA events, and
   prints torch.profiler's device time by kernel for one filter call.

It prints a `{"kernels": [...]}` JSON line before the last, and, as the
last line, `{"ok": true, "device": {...}}`. It imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import time

import numpy as np
import torch

from aesmc_tpu_torch import inference, resampling, statistics
from aesmc_tpu_torch.models import kalman, lgssm
from aesmc_tpu_torch.noise import NoiseSource
from aesmc_tpu_torch.ops import _build, resample_cuda

T, B, K = 200, 10, 10000
# The bench's LGSSM (bench.py): x_0 ~ N(0, 1), x_t = 0.9 x_{t-1} + N(0, 1),
# y_t = x_t + N(0, 0.2^2).
TRANSITION_MULT, TRANSITION_SCALE = 0.9, 1.0
EMISSION_MULT, EMISSION_SCALE = 1.0, 0.2
# The repo's Kalman-oracle bound on log-Z (tests/test_inference.py).
LOG_Z_REL_TOL = 0.05


def phase(name):
    print(f"== {name}", flush=True)


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
    # Build from the sources in this checkout, never from a stale library.
    _build.library_path(resample_cuda.SOURCE).unlink(missing_ok=True)
    start = time.perf_counter()
    _build.load(resample_cuda.SOURCE)
    seconds = time.perf_counter() - start
    print(f"built {resample_cuda.SOURCE} with {_build.nvcc_path()} in "
          f"{seconds:.2f} s", flush=True)


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


def kernel_phase(dev):
    """K1 against its plain version on the card; returns the max abs error."""
    phase("3 kernel against its plain version")
    generator = torch.Generator(device=dev)
    generator.manual_seed(0)
    cases = [(10, 10000, 1, "normal"), (3, 1000, 3, "normal"),
             (1, 1, 1, "normal"), (2, 1025, 1, "normal"),
             (1, 8388608, 1, "normal"), (3, 1000, 2, "one_particle"),
             (3, 1000, 2, "neg_inf")]
    worst = 0.0
    for batch, k, d, kind in cases:
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


@torch.no_grad()
def slice_phase(dev):
    phase("4 slice: LGSSM SMC, T=200, B=10, K=10,000")
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
    resample_cuda.LAUNCHES = 0
    out = smc(proposal, 1, return_latents=False, return_log_weight=False)
    torch.cuda.synchronize()
    launches = resample_cuda.LAUNCHES
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
    kernel_ms = {}
    for emit_idx in (False, True):
        k_runs, p_runs = [], []
        for which in ("plain", "kernel", "kernel", "plain"):
            if which == "kernel":
                k_runs.append(_cuda_ms(
                    lambda: resample_cuda.resample_and_gather_systematic(
                        cdf, u, value, emit_idx), warmup=20, repeat=200))
            else:
                p_runs.append(_cuda_ms(
                    lambda: resample_cuda.resample_and_gather_systematic_torch(
                        cdf, u, value, emit_idx), warmup=20, repeat=200))
        kernel_ms[emit_idx] = (float(np.mean(k_runs)), float(np.mean(p_runs)))
        print(f"K1 at [{B}, {K}], D=1, emit_idx={emit_idx}: kernel "
              f"{kernel_ms[emit_idx][0] * 1e3:.2f} us/call (runs "
              f"{k_runs}), plain {kernel_ms[emit_idx][1] * 1e3:.2f} us/call "
              f"(runs {p_runs})", flush=True)

    _profile(filt("cuda"))
    return launches, kernel_ms[False]


def _profile(fn):
    """Device time by kernel name over one filter call."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    print(prof.key_averages().table(sort_by="cuda_time_total",
                                    row_limit=25), flush=True)


def main():
    dev = device_phase()
    build_phase()
    max_abs_err = kernel_phase(dev)
    launches, (ms, plain_ms) = slice_phase(dev)
    print(json.dumps({"kernels": [{
        "name": "resample_systematic",
        "route": "cuda",
        "source": "aesmc_tpu_torch/csrc/resample_systematic.cu",
        "replaces": "aesmc_tpu/ops/resample_pallas.py:385",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
