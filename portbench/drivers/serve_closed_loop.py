"""The streaming filter serving one observation at a time, closed loop.

Set-up builds `online.make_online_filter` over the configuration's
filter, one long observation series a stream from the seed (held on the
host, where observations arrive), consumes the first observation
(`init_fn`) and captures one step (`online.CapturedStep`). In the window
each observation is submitted when the previous one's `log_pred` has been
read: its latency runs from the submission (before the observation is
copied in) to its `log_pred` being readable on the host. A traced run
serves as long without the profiler first, for the latencies its
per-layer metrics read. On the CPU the step runs eagerly.

The check: a sample of the served observations, drawn from the seed (the
last one always among them), each row's `log_pred` against the
reference's exact log p(y_t | y_{<t}); `pred_gap` is the widest gap in
nats.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from aesmc_tpu_torch import online
from aesmc_tpu_torch.noise import NoiseSource

from portbench.harness import checks, stats
from portbench.harness.trace import Window


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.on_card = torch.device(ctx.device).type == "cuda"
        self.served = 0
        self.latencies = self.untraced = []
        self.attempted = self.failed = 0

    def setup(self):
        ctx, traffic = self.ctx, self.ctx.traffic
        model = ctx.config["model"]
        b, k = traffic["batch_size"], traffic["num_particles"]
        series = ctx.model.observations(model, ctx.generator(1),
                                        traffic["max_observations"], b)
        self.series = series.cpu()
        if self.on_card:
            self.series = self.series.pin_memory()
        ctx.mark("observations made")
        components, _ = ctx.model.filter_components(model, ctx.device)
        init_fn, step_fn = online.make_online_filter(
            *components, k, resampling_method=traffic["resampling_method"])
        noise = NoiseSource(ctx.generator(2))
        with torch.no_grad():
            state = init_fn(series[0], noise)
            ctx.mark("first observation consumed")
            if self.on_card:
                self.step = online.CapturedStep(step_fn, state, series[1],
                                                noise)
            else:
                self.step = _Eager(step_fn, state, noise, ctx.device)
        self.preds = np.full((self.series.shape[0], b), np.nan, np.float32)
        ctx.mark("captured")
        self._serve(Window(device=ctx.device), traffic["warmup_seconds"])

    def run(self, window, seconds):
        if window.traced:
            # The same stretch without the profiler first: its latencies
            # are the ones `serve_obs_p50_ms` and `step_mfu.serve` read.
            self.untraced = self._serve(Window(device=self.ctx.device),
                                        seconds)
        self.latencies = self._serve(window, seconds)
        self.attempted = self.served

    def _serve(self, window, seconds):
        series, preds, latencies = self.series, self.preds, []
        t = self.served + 1
        window.open()
        with torch.no_grad():
            while t < series.shape[0]:
                submitted = time.perf_counter()
                info = self.step(series[t])
                preds[t] = info["log_pred"].cpu().numpy()
                done = time.perf_counter()
                latencies.append(done - submitted)
                t += 1
                if done - window.start >= seconds:
                    break
        window.close()
        self.served = t - 1
        if len(latencies) >= 2000:
            parts = np.array_split(np.asarray(latencies) * 1e3, 10)
            self.ctx.mark("p50, p95 ms by tenths of the window: " + str(
                [(round(float(np.median(p)), 4),
                  round(float(np.percentile(p, 95)), 4)) for p in parts]))
        return latencies

    def end_to_end(self):
        return {"serve_obs_p95_ms": stats.percentile(self.latencies, 95) * 1e3}

    def records(self):
        return {"items": len(self.latencies),
                "item_s": sum(self.untraced) / len(self.untraced),
                "latencies_s": list(self.untraced)}

    def release(self):
        served = self.preds[1:self.served + 1]
        self.failed = int(np.sum(~np.isfinite(served).all(axis=1)))
        self.step = None

    def check(self):
        ctx = self.ctx
        model = ctx.reference.model_params(ctx.config)
        y = self.series[:self.served + 1].double().numpy()
        exact = ctx.reference.exact_terms(y, model)
        picked = 1 + checks.sample(self.served, ctx.check["sample"], ctx.seed)
        gap = checks.widest_gap(self.preds[picked], exact[picked])
        return checks.checks({"pred_gap": gap}, ctx.check["limits"])


class _Eager:
    """`CapturedStep`'s contract without a graph (the CPU)."""

    def __init__(self, step_fn, state, noise, device):
        self.step_fn, self.state, self.noise = step_fn, state, noise
        self.device = device

    def __call__(self, observation):
        self.state, info = self.step_fn(self.state,
                                        observation.to(self.device),
                                        self.noise)
        return info
