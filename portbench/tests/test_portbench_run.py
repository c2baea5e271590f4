"""Runs of every cell at small sizes on the CPU: sound runs come out
correct, and a timed path broken underneath comes out not correct.

The sizes and limits here are the tests' own (a test run cannot hold the
cells' sizes); the faults are those the check must catch: an answer
altered where it is produced, half of the batch left out with the mean
taken over the rest, and a step that returns its state unchanged.
No cell exchanges anything between chips."""

import time

import pytest
import torch

from aesmc_tpu_torch import inference, online
from portbench.harness import runner
from portbench.tests.conftest import load_spec

SEED = 2 ** 31 + 11
SMALL = {
    "lgssm-filter": {
        "traffic": {"num_timesteps": 200, "batch_size": 4,
                    "num_particles": 256, "max_calls": 200,
                    "warmup_seconds": 0.1},
        "check": {"sample": 8, "limits": {"logz_gap": 1.5}}},
    "lgssm-serve": {
        "traffic": {"batch_size": 4, "num_particles": 256,
                    "max_observations": 1000, "warmup_seconds": 0.1},
        "check": {"sample": 64, "limits": {"pred_gap": 0.3}}},
}


def run(name, trace=False, seconds=0.5):
    spec = load_spec()
    return runner.run_cell(spec, name, SEED, seconds, trace, "cpu",
                           time.perf_counter(), SMALL[name])


@pytest.mark.parametrize("name", list(SMALL))
def test_sound_run_is_correct(name):
    line = run(name)
    assert line["correct"], line["checks"]
    assert list(line)[-1] == "checks"
    assert line["failed"] == 0 and line["attempted"] > 0
    assert {"setup_s"} < set(line["metrics"])
    assert all(m["value"] > 0 for m in line["metrics"].values())


@pytest.mark.parametrize("name", ["lgssm-filter", "lgssm-serve"])
def test_traced_run_reads_its_host_metrics(name):
    line = run(name, trace=True, seconds=0.3)
    assert line["correct"]
    assert "setup_s" not in line["metrics"]
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


def _altered_infer(real):
    def infer(*args, **kwargs):
        out = real(*args, **kwargs)
        out["log_marginal_likelihood"] = out["log_marginal_likelihood"] + 5.0
        return out
    return infer


def _half_batch_infer(real):
    def infer(*args, **kwargs):
        out = real(*args, **kwargs)
        log_z = out["log_marginal_likelihood"]
        half = log_z.shape[0] // 2
        out["log_marginal_likelihood"] = torch.cat([
            log_z[:half], log_z[:half].mean().expand(log_z.shape[0] - half)])
        return out
    return infer


def _stuck_filter(real):
    def make(*args, **kwargs):
        init_fn, step_fn = real(*args, **kwargs)

        def step(state, y, noise):
            _, info = step_fn(state, y, noise)
            return state, info
        return init_fn, step
    return make


def _altered_filter(real):
    def make(*args, **kwargs):
        init_fn, step_fn = real(*args, **kwargs)

        def step(state, y, noise):
            state, info = step_fn(state, y, noise)
            return state, dict(info, log_pred=info["log_pred"] + 1.0)
        return init_fn, step
    return make


FAULTS = [
    ("lgssm-filter", "answer altered", inference, "infer", _altered_infer),
    ("lgssm-filter", "half the batch", inference, "infer", _half_batch_infer),
    ("lgssm-serve", "state unchanged", online, "make_online_filter",
     _stuck_filter),
    ("lgssm-serve", "answer altered", online, "make_online_filter",
     _altered_filter),
]


@pytest.mark.parametrize("name,fault,module,attr,broken", FAULTS,
                         ids=[f"{n}-{f}" for n, f, *_ in FAULTS])
def test_broken_timed_path_is_not_correct(monkeypatch, name, fault, module,
                                          attr, broken):
    monkeypatch.setattr(module, attr, broken(getattr(module, attr)))
    line = run(name)
    assert not line["correct"], (fault, line["checks"])
