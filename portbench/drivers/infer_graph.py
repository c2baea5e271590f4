"""An `inference.infer('smc', ...)` log-Z call captured in a CUDA graph,
replayed back to back for the window.

Set-up builds the configuration's filter and its observations from the
seed, makes one warm-up call and captures one call; each replay writes its
log-Z into its own row of a device buffer. The window dispatches replays
ahead of the device (a few in flight) and ends when the device has
finished the last one dispatched before `--seconds` passed. A traced run
replays as long without the profiler first, for the time of a call, and
after the window makes one eager call of the same body under a profiler
of its own, into a scratch row: the span readers read that call
(`records()['spans']`, `trace.spans`); it is no call of the window, and
the check never sees it. On the CPU (the tests) the same call runs
eagerly.

The check: a sample of the window's calls, drawn from the seed (the last
one always among them), each row's log-Z against the reference's exact
log-Z of that row's observations; `logz_gap` is the widest gap in nats.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from aesmc_tpu_torch import inference
from aesmc_tpu_torch.noise import NoiseSource

from portbench.harness import checks, graph, stats, trace
from portbench.harness.trace import Window


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.on_card = torch.device(ctx.device).type == "cuda"
        self.calls = 0
        self.item_s = None
        self.spans = {}
        self.attempted = self.failed = 0

    def setup(self):
        ctx, traffic = self.ctx, self.ctx.traffic
        model = ctx.config["model"]
        t, b, k = (traffic[n] for n in ("num_timesteps", "batch_size",
                                        "num_particles"))
        self.components, _ = ctx.model.filter_components(model, ctx.device)
        self.obs = ctx.model.observations(model, ctx.generator(1), t, b)
        noise = NoiseSource(ctx.generator(2))
        ctx.mark("filter and observations built")
        self.out = torch.empty((traffic["max_calls"], b), device=ctx.device)
        self.slot = torch.zeros((1,), dtype=torch.long, device=ctx.device)

        def body(out, slot):
            with torch.no_grad():
                log_z = inference.infer(
                    "smc", self.obs, *self.components, k, noise=noise,
                    resampling_method=traffic["resampling_method"],
                    return_log_marginal_likelihood=True,
                    return_latents=False,
                    return_log_weight=False)["log_marginal_likelihood"]
                out.index_copy_(0, slot, log_z[None])
                slot.add_(1)

        def call():
            body(self.out, self.slot)

        self.body = body
        if self.on_card:
            self.graph, _ = graph.capture(call, noise.generator)
            self.slot.zero_()
            self.call = self.graph.replay
        else:
            self.call = call
        ctx.mark("captured")
        warm = Window(device=ctx.device)
        self._replay(warm, traffic["warmup_seconds"])
        self.slot.zero_()
        self.calls = 0

    def run(self, window, seconds):
        if window.traced:
            # The same stretch without the profiler first: the time of a
            # call that `step_mfu.infer` divides by.
            stretch = Window(device=self.ctx.device)
            self._replay(stretch, seconds)
            self.item_s = stretch.seconds / self.calls
        done = self.calls
        self._replay(window, seconds)
        self.window_s = window.seconds
        self.window_calls = self.calls - done
        self.attempted = self.calls
        if window.traced:
            self.spans = self._eager_item()

    def _eager_item(self):
        """The spans of one eager call of the body, under a profiler of
        its own, into a scratch row."""
        scratch = torch.empty_like(self.out[:1])
        slot = torch.zeros_like(self.slot)
        item = Window(traced=True, device=self.ctx.device)
        item.open()
        self.body(scratch, slot)
        item.close()
        found = trace.spans(item.profiler)
        self.ctx.mark(f"eager item's spans: {found}")
        return found

    def _replay(self, window, seconds):
        capacity = self.out.shape[0]
        ahead = graph.Ahead() if self.on_card else None
        window.open()
        while self.calls < capacity:
            self.call()
            self.calls += 1
            if ahead is not None:
                ahead.launched()
            if time.perf_counter() - window.start >= seconds:
                break
        window.close()
        if ahead is not None:
            self.ctx.mark(f"ms a call, by stretches of {ahead.every}: "
                          f"{[round(ms, 4) for ms in ahead.stretch_ms()]}")

    def end_to_end(self):
        return {"infer_call_ms": stats.per_item_ms(self.window_s,
                                                   self.window_calls)}

    def records(self):
        return {"items": self.window_calls, "item_s": self.item_s,
                "spans": self.spans}

    def release(self):
        self.log_z = self.out[:self.calls].double().cpu().numpy()
        self.obs_host = self.obs.double().cpu().numpy()
        self.failed = int(np.sum(~np.isfinite(self.log_z).all(axis=1)))
        del self.out, self.obs, self.components, self.call, self.body
        self.graph = None

    def check(self):
        ctx = self.ctx
        model = ctx.reference.model_params(ctx.config)
        exact = ctx.reference.exact_log_z(self.obs_host, model)
        picked = checks.sample(self.calls, ctx.check["sample"], ctx.seed)
        gap = checks.widest_gap(self.log_z[picked], exact[None, :])
        return checks.checks({"logz_gap": gap}, ctx.check["limits"])
