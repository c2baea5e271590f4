"""The CDF kernel's wrapper (`ops.normalized_cdf_cuda`) and the route to it.

On the 'cuda' route the resampling steps build their CDF through
`resampling._cuda_route_cdf`: one launch of the kernel for a tensor on
the card, `resampling._normalized_cumsum` otherwise. The kernel runs only
on the card (`chip_smoke.py` phase 3k holds it against the plain CDF).
Here: the helper gives the plain CDF's bits on CPU tensors, the 'cuda'
branches of the resampling steps reach it and the 'torch' route does not
(the 'cuda' route is patched onto CPU tensors, where every kernel wrapper
runs its plain version), a CPU filter's log-Z and ancestors are those of
the plain CDF's call, and the wrapper refuses what the kernel does not
take.
"""

import ctypes
import math

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import torch_threads  # noqa: F401
from aesmc_tpu_torch import inference, resampling, statistics
from aesmc_tpu_torch.models import lgssm
from aesmc_tpu_torch.noise import NoiseSource
from aesmc_tpu_torch.ops import _launch, normalized_cdf_cuda


def _log_weights(batch, k, kind, seed=0):
    generator = torch.Generator().manual_seed(seed)
    logw = 2.0 * torch.randn(batch, k, generator=generator)
    if kind == "-inf entries":
        logw[:, 1::3] = -math.inf
        logw[0, -1] = -math.inf
    elif kind == "one dominant":
        logw[:, k // 2] += 60.0
    elif kind == "no finite entry":
        logw[1] = -math.inf
    return logw


@pytest.mark.parametrize("batch,k,kind", [
    (1, 1, "normal"), (10, 10000, "normal"), (3, 257, "-inf entries"),
    (2, 1000, "one dominant"), (3, 50, "no finite entry")])
def test_helper_gives_the_plain_cdf_on_the_cpu(batch, k, kind):
    logw = _log_weights(batch, k, kind)
    got = resampling._cuda_route_cdf(logw)
    want = resampling._normalized_cumsum(logw)
    assert got.dtype == torch.float32 and got.shape == (batch, k)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))
    if kind == "no finite entry":
        assert bool(torch.isnan(got[1, :-1]).all()) and float(got[1, -1]) == 1
    assert bool((got[:, -1] == 1.0).all())


@pytest.fixture
def cdf_calls(monkeypatch):
    """The 'cuda' route on CPU tensors, and the log-weights each call of
    the route's CDF helper got."""
    calls = []
    helper = resampling._cuda_route_cdf

    def spy(log_weight):
        calls.append(tuple(log_weight.shape))
        return helper(log_weight)

    monkeypatch.setattr(resampling, "_cuda_route_cdf", spy)
    monkeypatch.setattr(
        resampling, "_route",
        lambda device, implementation: "torch" if implementation == "torch"
        else "cuda")
    return calls


def _resample(implementation, method):
    logw = _log_weights(2, 1500, "normal", seed=3)
    value = {"x": torch.randn(2, 1500, 3), "s": torch.arange(
        3000, dtype=torch.int32).reshape(2, 1500)}
    return resampling._resample(logw, NoiseSource.seeded(4, "cpu"), value,
                                method, implementation, True)


def _sample_indices(implementation, method):
    logw = _log_weights(3, 700, "normal", seed=5)
    return (resampling.sample_indices(logw, NoiseSource.seeded(6, "cpu"),
                                      method, implementation),)


def _soft_resample(implementation, method):
    logw = _log_weights(2, 900, "normal", seed=7)
    return resampling._soft_resample(logw, NoiseSource.seeded(8, "cpu"),
                                     torch.randn(2, 900), 0.5,
                                     implementation, True)


@pytest.mark.parametrize("step,method", [
    (_resample, "systematic"), (_resample, "stratified"),
    (_resample, "multinomial"), (_sample_indices, "systematic"),
    (_sample_indices, "stratified"), (_sample_indices, "multinomial"),
    (_soft_resample, "soft")])
def test_cuda_branches_reach_the_helper_and_torch_does_not(step, method,
                                                           cdf_calls):
    got = step("cuda", method)
    assert len(cdf_calls) == 1
    want = step("torch", method)
    assert len(cdf_calls) == 1
    # With the plain CDF on both routes their ancestors agree exactly.
    assert torch.equal(got[0], want[0])


def _filter(noise_seed):
    initial = lgssm.Initial(0.0, 1.0)
    transition = lgssm.Transition(0.9, 1.0)
    emission = lgssm.Emission(1.0, 0.5)
    proposal = lgssm.Proposal.create(1.0, 1.0,
                                     torch.Generator().manual_seed(0))
    with torch.no_grad():
        _, obs = statistics.sample_from_prior(
            initial, transition, emission, 12, 3,
            NoiseSource.seeded(1, "cpu"))
        out = inference.infer(
            "smc", obs, initial, transition, emission, proposal, 400,
            noise=NoiseSource.seeded(noise_seed, "cpu"),
            return_log_marginal_likelihood=True,
            return_ancestral_indices=True)
    return out["log_marginal_likelihood"], out["ancestral_indices"]


def test_cpu_filter_bits_are_the_plain_cdfs(monkeypatch):
    calls = []
    helper = resampling._cuda_route_cdf

    def spy(log_weight):
        calls.append(1)
        return helper(log_weight)

    monkeypatch.setattr(resampling, "_cuda_route_cdf", spy)
    log_z, ancestors = _filter(2)
    assert not calls  # 'auto' on CPU tensors is the 'torch' route
    monkeypatch.setattr(
        resampling, "_route",
        lambda device, implementation: "torch" if implementation == "torch"
        else "cuda")
    routed = _filter(2)
    assert len(calls) == 11
    # The call each 'cuda' branch made before the helper existed.
    monkeypatch.setattr(resampling, "_cuda_route_cdf",
                        resampling._normalized_cumsum)
    plain = _filter(2)
    for got in (routed, (log_z, ancestors)):
        assert torch.equal(got[0], plain[0])
        assert torch.equal(got[1], plain[1])


@pytest.mark.parametrize("make,error", [
    (lambda: torch.zeros(2, 5, dtype=torch.float64), TypeError),
    (lambda: torch.zeros(5, 2).t(), ValueError),
    (lambda: torch.zeros(2, 5), ValueError),
    (lambda: torch.zeros(2, 5, device="meta"), ValueError)])
def test_wrapper_refuses_what_the_kernel_does_not_take(make, error):
    with pytest.raises(error):
        normalized_cdf_cuda.normalized_cdf(make())


@pytest.mark.parametrize("shape,match", [((5,), r"\[B, K\]"),
                                         ((2, 0), "particle counts")])
def test_wrapper_refuses_bad_shapes(shape, match):
    with FakeTensorMode(), pytest.raises(ValueError, match=match):
        normalized_cdf_cuda.normalized_cdf(torch.empty(shape, device="cuda"))


def test_launch_hands_the_entry_its_shapes(monkeypatch):
    seen = []

    def entry(source, symbol, argtypes):
        assert (source, symbol) == ("normalized_cdf.cu",
                                    "aesmc_normalized_cdf")
        assert argtypes == [ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 2 + \
            [ctypes.c_int, ctypes.c_void_p]

        def fn(*args):
            seen.append(args)
            return 0 if len(seen) == 1 else 7
        return fn

    monkeypatch.setattr(_launch, "entry", entry)
    monkeypatch.setattr(_launch, "target", lambda t: (3, 99))
    logw = torch.zeros(4, 9)
    before = normalized_cdf_cuda.LAUNCHES
    cdf = normalized_cdf_cuda._launch_kernel(logw)
    assert cdf.shape == (4, 9) and cdf.dtype == torch.float32
    assert seen[0] == (logw.data_ptr(), cdf.data_ptr(), 4, 9, 3, 99)
    assert normalized_cdf_cuda.LAUNCHES == before + 1
    with pytest.raises(RuntimeError, match="CUDA error 7"):
        normalized_cdf_cuda._launch_kernel(logw)
    assert normalized_cdf_cuda.LAUNCHES == before + 1


def test_traced_launch_goes_through_the_operator(monkeypatch):
    calls = []
    monkeypatch.setattr(_launch, "tracing", lambda: True)
    monkeypatch.setattr(normalized_cdf_cuda, "_kernel_op",
                        lambda logw: calls.append(logw.shape) or logw)
    with FakeTensorMode():
        logw = torch.empty(3, 7, device="cuda")
        normalized_cdf_cuda.normalized_cdf(logw)
        # The operator's fake version: a [B, K] float32 CDF on the card.
        cdf = torch.ops.aesmc_tpu_torch.normalized_cdf(logw)
    assert calls == [(3, 7)]
    assert cdf.shape == (3, 7) and cdf.dtype == torch.float32
    assert cdf.device.type == "cuda"
