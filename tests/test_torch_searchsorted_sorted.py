"""The port's index-only sorted search (K4) against the JAX package, and the
routes that reach it.

On the CPU the port's wrapper runs its plain PyTorch version; the JAX side
runs `searchsorted_sorted_cdf_pallas` (the Pallas merge kernel with
`cdf_input=True`) through the interpreter. Both search the JAX package's
CDF at the same positions, so the indices must be equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aesmc_tpu import resampling as jax_resampling
from aesmc_tpu.ops import resample_pallas
from aesmc_tpu_torch import resampling
from aesmc_tpu_torch.noise import NoiseSource
from aesmc_tpu_torch.ops import resample_sorted_cuda, searchsorted_sorted_cuda
from torch_replay import tensor as _t


def _neg_inf_log_weights(seed, batch, k):
    """N(0, 3^2) log-weights with runs of zero weight at both ends and
    inside each row: runs of equal CDF entries."""
    rng = np.random.default_rng(seed)
    logw = (rng.normal(size=(batch, k)) * 3.0).astype(np.float32)
    logw[:, : k // 4] = -np.inf
    logw[:, k // 2: k // 2 + k // 8] = -np.inf
    logw[:, -3:] = -np.inf
    return logw


@pytest.mark.parametrize("method", ["stratified", "multinomial"])
@pytest.mark.parametrize("kc,kp", [(1000, 257), (300, 1200), (4096, 1030)])
def test_plain_search_matches_pallas(kc, kp, method):
    batch = 2
    cdf = np.asarray(jax_resampling._normalized_cumsum(
        jnp.asarray(_neg_inf_log_weights(kc + kp, batch, kc))))
    pos = np.asarray(jax_resampling.resampling_positions(
        jnp.zeros((batch, kp), jnp.float32), jax.random.PRNGKey(kc), method))
    want = np.asarray(resample_pallas.searchsorted_sorted_cdf_pallas(
        jnp.asarray(cdf), jnp.asarray(pos), interpret=True))
    got = searchsorted_sorted_cuda.searchsorted_sorted(_t(cdf), _t(pos))
    assert got.dtype == torch.int32 and got.shape == (batch, kp)
    np.testing.assert_array_equal(got.numpy(), want)
    # No zero-weight particle is ever picked.
    assert np.isfinite(_neg_inf_log_weights(kc + kp, batch, kc)[
        np.arange(batch)[:, None], got.numpy()]).all()


def test_wrapper_checks_inputs_and_counts_no_cpu_launch():
    cdf = torch.linspace(0.1, 1.0, 10).repeat(2, 1)
    pos = torch.linspace(0.0, 0.95, 12).repeat(2, 1)
    before = searchsorted_sorted_cuda.LAUNCHES
    idx = searchsorted_sorted_cuda.searchsorted_sorted(cdf, pos)
    assert searchsorted_sorted_cuda.LAUNCHES == before
    assert torch.equal(idx, searchsorted_sorted_cuda.searchsorted_sorted_torch(
        cdf, pos))
    bad = [
        (cdf.double(), pos, TypeError),
        (cdf, pos.half(), TypeError),
        (cdf.numpy(), pos, TypeError),
        (cdf.t().contiguous().t(), pos, ValueError),
        (cdf, pos.t().contiguous().t(), ValueError),
        (cdf, pos[:1], ValueError),
        (cdf[0], pos, ValueError),
        (cdf, torch.zeros(2, 0), ValueError),
        (cdf.to("meta"), pos.to("meta"), ValueError),
        (cdf, pos.to("meta"), ValueError),
    ]
    for c, p, err in bad:
        with pytest.raises(err):
            searchsorted_sorted_cuda.searchsorted_sorted(c, p)


@pytest.fixture
def kernel_route_spy(monkeypatch):
    """'auto' takes the 'cuda' route on CPU tensors (each wrapper then runs
    its plain version), with K4's wrapper recorded and K3's forbidden."""
    calls = []
    search = searchsorted_sorted_cuda.searchsorted_sorted

    def spy(cdf, pos):
        calls.append(tuple(pos.shape))
        return search(cdf, pos)

    def no_k3(*args, **kwargs):
        raise AssertionError("an index-only search reached K3")

    monkeypatch.setattr(
        resampling, "_route",
        lambda device, implementation: "torch" if implementation == "torch"
        else "cuda")
    monkeypatch.setattr(searchsorted_sorted_cuda, "searchsorted_sorted", spy)
    monkeypatch.setattr(resample_sorted_cuda, "resample_and_gather_sorted",
                        no_k3)
    return calls


def _noise(seed):
    return NoiseSource(torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("method", ["stratified", "multinomial"])
def test_index_only_routes_reach_k4(method, kernel_route_spy):
    batch, k = 3, 500
    logw = _t(_neg_inf_log_weights(5, batch, k))
    want = resampling.sample_ancestral_index(logw, _noise(1), method,
                                             implementation="torch")

    got = resampling.sample_ancestral_index(logw, _noise(1), method)
    assert torch.equal(got, want)
    assert kernel_route_spy == [(batch, k)]

    # Only int32 particles: the search is K4's, the gather K5's.
    states = torch.arange(batch * k, dtype=torch.int32).reshape(batch, k)
    idx, out = resampling.sample_ancestral_index_and_resample(
        logw, _noise(1), {"s": states}, method)
    assert torch.equal(idx, want)
    assert torch.equal(out["s"], torch.gather(states, 1, want.long()))
    assert kernel_route_spy == [(batch, k)] * 2


def test_k3_without_columns_hands_the_search_to_k4():
    cdf = _t(np.asarray(jax_resampling._normalized_cumsum(
        jnp.asarray(_neg_inf_log_weights(3, 2, 300)))))
    pos = torch.linspace(0.0, 0.99, 77).repeat(2, 1)
    want = searchsorted_sorted_cuda.searchsorted_sorted_torch(cdf, pos)
    for value in (None, torch.zeros(2, 300, 0)):
        for emit_idx in (True, False):
            idx, out = resample_sorted_cuda.resample_and_gather_sorted(
                cdf, pos, value, emit_idx)
            assert out.shape == (2, 77, 0)
            assert torch.equal(idx, want) if emit_idx else idx is None
    with pytest.raises(ValueError):
        resample_sorted_cuda.resample_and_gather_sorted(
            cdf, pos, torch.zeros(2, 299, 0))
