"""The port's spans (`aesmc_tpu_torch.profiling.annotate`): free while no
profiler records, at the engine's and the streaming step's stages while
one does, and absent from an exported step.

Small CPU sizes: an LGSSM at T = 6, B = 2 and K = 1,100 (above
`resampling.DENSE_GATHER_MAX_K`, so that the 'torch' route searches and
gathers as the card's kernels do) or K = 64 for the streaming step.
"""

import io

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import torch_threads  # noqa: F401
from aesmc_tpu_torch import inference, online, profiling
from aesmc_tpu_torch.models import lgssm
from aesmc_tpu_torch.noise import NoiseSource

T, B, K = 6, 2, 1100
ENGINE = ("aesmc.smc.initial", "aesmc.smc.resample", "aesmc.resample.cdf",
          "aesmc.resample.kernel", "aesmc.smc.propose", "aesmc.smc.weigh",
          "aesmc.smc.estimate")


def _components():
    return (lgssm.Initial(0.0, 1.0), lgssm.Transition(0.9, 1.0),
            lgssm.Emission(1.0, 0.3), lgssm.Proposal(
                0.5, 0.0, [0.4, 0.5], 0.0, 0.8, 0.8))


def _observations(t=T):
    return torch.randn((t, B), generator=torch.Generator().manual_seed(5))


def _noise(seed=1):
    return NoiseSource(torch.Generator().manual_seed(seed))


def _spans(prof):
    """[(name, start_ns, end_ns)] of the program's spans, by start."""
    return sorted(
        ((e.name(), e.start_ns(), e.end_ns())
         for e in prof.profiler.kineto_results.events()
         if e.name().startswith("aesmc.")), key=lambda s: (s[1], -s[2]))


def _counts(spans):
    out = {}
    for name, _, _ in spans:
        out[name] = out.get(name, 0) + 1
    return out


def _inside(child, parents):
    return any(s <= child[1] and child[2] <= e for _, s, e in parents)


def test_idle_span_is_shared_and_makes_no_range(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a RecordFunction was made")

    monkeypatch.setattr(profiling, "record_function", refuse)
    span = profiling.annotate("aesmc.test.idle")
    assert isinstance(span, profiling._Idle)
    assert profiling.annotate("aesmc.test.idle") is span
    with span as entered:
        assert entered is span

    @profiling.annotate("aesmc.test.idle")
    def double(x):
        return 2 * x

    assert double(3) == 6
    inference.infer("smc", _observations(), *_components(), 64,
                    noise=_noise(), return_log_marginal_likelihood=True)


def test_span_records_and_decorates():
    @profiling.annotate("aesmc.test.decorated")
    def double(x):
        return 2 * x

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.annotate("aesmc.test.outer"):
            assert double(torch.ones(2)).sum() == 4
    spans = _spans(prof)
    assert [s[0] for s in spans] == ["aesmc.test.outer",
                                     "aesmc.test.decorated"]
    assert _inside(spans[1], spans[:1])


def test_infer_spans_each_stage(tmp_path):
    with profiling.trace(str(tmp_path)) as prof:
        out = inference.infer("smc", _observations(), *_components(), K,
                              noise=_noise(),
                              return_log_marginal_likelihood=True)
    assert torch.isfinite(out["log_marginal_likelihood"]).all()
    spans = _spans(prof)
    counts = _counts(spans)
    assert counts == {"aesmc.smc.initial": 1, "aesmc.smc.estimate": 1,
                      **{name: T - 1 for name in ENGINE[1:6]}}
    resample = [s for s in spans if s[0] == "aesmc.smc.resample"]
    for name in ("aesmc.resample.cdf", "aesmc.resample.kernel"):
        assert all(_inside(s, resample) for s in spans if s[0] == name)
    text = (tmp_path / "trace.json").read_text()
    assert all(name in text for name in ENGINE)


@pytest.mark.parametrize("method", ["systematic", "stratified",
                                    "multinomial", "residual"])
def test_online_step_spans_as_infer(method):
    init_fn, step_fn = online.make_online_filter(
        *_components(), 64, resampling_method=method)
    obs, noise = _observations(), _noise()
    with torch.no_grad():
        fs = init_fn(obs[0], noise)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for t in range(1, T):
                fs, _ = step_fn(fs, obs[t], noise)
    counts = _counts(_spans(prof))
    assert {counts[name] for name in ("aesmc.smc.resample",
                                      "aesmc.resample.kernel",
                                      "aesmc.smc.propose",
                                      "aesmc.smc.weigh")} == {T - 1}
    assert counts.get("aesmc.resample.cdf", 0) == (
        0 if method == "residual" else T - 1)


_SEEN = []


class _Spanned(torch.nn.Module):
    def forward(self, x):
        span = profiling.annotate("aesmc.test.export")
        _SEEN.append(span)
        with span:
            return 2 * x


def test_exported_step_holds_no_profiler_node():
    """Under `torch.export` a span is the no-op even while a profiler
    records, and the exported streaming step holds no profiler node."""
    init_fn, step_fn = online.make_online_filter(*_components(), 64)
    obs = _observations()
    with torch.no_grad():
        fs = init_fn(obs[0], _noise())
    _SEEN.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        torch.export.export(_Spanned(), (torch.ones(2),))
        blob = online.export_step(step_fn, fs, obs[1])
    assert _SEEN and all(isinstance(s, profiling._Idle) for s in _SEEN)
    program = torch.export.load(io.BytesIO(blob))
    targets = [str(node.target) for node in program.graph.nodes]
    assert not any("profiler" in t or "record_function" in t
                   for t in targets), targets
