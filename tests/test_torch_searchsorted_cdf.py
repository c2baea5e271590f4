"""The port's fused CDF + search (K6), its index-only sorted search (K4)
and `sample_ancestral_index` against the JAX package's Pallas kernels, run
through the interpreter.

K6 builds its CDF from exact fixed-point prefix sums, not in float32 as
either package's `_normalized_cumsum` does, so its indices agree within the
JAX package's bound for CDFs summed in another order
(`tests/test_resample_pallas.py:39-49`): fewer than 0.5% differ, each by at
most 3. `sample_ancestral_index` is exact when it searches the JAX
package's CDF, and within the same bound on its own.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aesmc_tpu import resampling as jax_resampling
from aesmc_tpu.ops import resample_pallas
from aesmc_tpu_torch import resampling
from aesmc_tpu_torch.ops import (resample_sorted_cuda, searchsorted_cdf_cuda,
                                 searchsorted_sorted_cuda)
from torch_replay import ReplayNoise, tensor as _t

# The JAX package's bound on index differences from a CDF summed in
# another order (tests/test_resample_pallas.py:39-49).
MISMATCH_FRACTION, MISMATCH_DISTANCE = 0.005, 3


def _assert_within_bound(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert (got != want).mean() < MISMATCH_FRACTION
    assert np.abs(got.astype(np.int64) - want).max() <= MISMATCH_DISTANCE


def _log_weights(seed, batch, k, one_particle=False):
    rng = np.random.default_rng(seed)
    logw = (rng.normal(size=(batch, k)) * 2).astype(np.float32)
    if one_particle:
        logw[:] = -np.inf
        logw[np.arange(batch), rng.integers(0, k, size=batch)] = 0.0
    return logw


def _positions(batch, k, method, seed):
    return np.asarray(jax_resampling.resampling_positions(
        jnp.zeros((batch, k), jnp.float32), jax.random.PRNGKey(seed),
        method))


@pytest.mark.parametrize("one_particle", [False, True])
@pytest.mark.parametrize("batch,k", [(3, 100), (2, 1000), (2, 3000)])
def test_plain_k6_matches_pallas(batch, k, one_particle):
    logw = _log_weights(k, batch, k, one_particle)
    pos = _positions(batch, k, "systematic", k + 1)
    value = np.random.default_rng(0).normal(size=(batch, k)).astype(
        np.float32)
    want_idx, want = resample_pallas.searchsorted_cdf_pallas(
        jnp.asarray(logw), jnp.asarray(pos), (jnp.asarray(value),),
        interpret=True)
    idx, got = searchsorted_cdf_cuda.searchsorted_cdf(
        _t(logw), _t(pos), _t(value)[:, :, None])
    assert idx.dtype == torch.int32 and got.shape == (batch, k, 1)
    if one_particle:
        np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    else:
        _assert_within_bound(idx.numpy(), want_idx)
    # Gathered values are the values at the port's own indices.
    np.testing.assert_array_equal(
        got[:, :, 0].numpy(), np.take_along_axis(value, idx.numpy(), 1))
    assert torch.equal(searchsorted_cdf_cuda.searchsorted_cdf(_t(logw),
                                                              _t(pos)), idx)


def test_plain_k6_is_the_port_cdf_search():
    """Without rounding differences (one slot per particle, weights that
    sum exactly), K6's plain version is a search of the port's CDF."""
    logw = np.log(np.full((2, 8), 0.125, np.float32))
    pos = np.tile(np.linspace(0.0, 0.99, 8, dtype=np.float32), (2, 1))
    want = torch.searchsorted(resampling._normalized_cumsum(_t(logw)),
                              _t(pos), right=True).clamp(max=7)
    idx = searchsorted_cdf_cuda.searchsorted_cdf(_t(logw), _t(pos))
    assert torch.equal(idx, want.to(torch.int32))


def test_k6_wrapper_checks_inputs_and_counts_no_cpu_launch():
    logw = torch.zeros(2, 10)
    pos = torch.linspace(0.0, 0.95, 12).repeat(2, 1)
    before = searchsorted_cdf_cuda.LAUNCHES
    idx = searchsorted_cdf_cuda.searchsorted_cdf(logw, pos)
    assert searchsorted_cdf_cuda.LAUNCHES == before and idx.shape == (2, 12)
    bad = [
        (logw.double(), pos, None, TypeError),
        (logw, pos, torch.zeros(2, 10), ValueError),
        (logw, pos[:1], None, ValueError),
        (logw.to("meta"), pos.to("meta"), None, ValueError),
    ]
    for lw, p, v, err in bad:
        with pytest.raises(err):
            searchsorted_cdf_cuda.searchsorted_cdf(lw, p, v)


@pytest.mark.parametrize("method", ["systematic", "stratified",
                                    "multinomial"])
@pytest.mark.parametrize("batch,k", [(3, 100), (2, 1000)])
def test_sample_ancestral_index_matches_pallas(batch, k, method,
                                               monkeypatch):
    logw = _log_weights(7 * k, batch, k)
    key = jax.random.PRNGKey(k)
    want = np.asarray(resample_pallas.sample_ancestral_index_pallas(
        jnp.asarray(logw), key, method=method, interpret=True))

    def noise():
        if method == "multinomial":
            return ReplayNoise(exponentials=[jax.random.exponential(
                key, (batch, k + 1), dtype=jnp.float32)])
        shape = (batch, 1) if method == "systematic" else (batch, k)
        return ReplayNoise(uniforms=[jax.random.uniform(
            key, shape, dtype=jnp.float32)])

    own = resampling.sample_ancestral_index(_t(logw), noise(), method,
                                            implementation="torch")
    assert own.dtype == torch.int32 and own.shape == (batch, k)
    _assert_within_bound(own.numpy(), want)
    monkeypatch.setattr(resampling, "_normalized_cumsum", lambda lw: _t(
        jax_resampling._normalized_cumsum(jnp.asarray(lw.numpy()))))
    got = resampling.sample_ancestral_index(_t(logw), noise(), method,
                                            implementation="torch")
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kc,kp", [(1000, 257), (300, 1200), (1, 5)])
def test_index_only_search_matches_pallas(kc, kp):
    """K4 at Kc != Kp: `searchsorted_sorted` and K3 with value None or
    D = 0 (which hand the search to K4), against
    `searchsorted_sorted_cdf_pallas`."""
    batch = 2
    cdf = np.asarray(jax_resampling._normalized_cumsum(
        jnp.asarray(_log_weights(kc, batch, kc))))
    pos = _positions(batch, kp, "stratified", kc + kp)
    want = np.asarray(resample_pallas.searchsorted_sorted_cdf_pallas(
        jnp.asarray(cdf), jnp.asarray(pos), interpret=True))
    before = searchsorted_sorted_cuda.LAUNCHES
    got = searchsorted_sorted_cuda.searchsorted_sorted(_t(cdf), _t(pos))
    assert got.dtype == torch.int32 and got.shape == (batch, kp)
    np.testing.assert_array_equal(got.numpy(), want)
    for value in (None, torch.zeros(batch, kc, 0)):
        idx, out = resample_sorted_cuda.resample_and_gather_sorted(
            _t(cdf), _t(pos), value)
        assert torch.equal(idx, got) and out.shape == (batch, kp, 0)
    assert searchsorted_sorted_cuda.LAUNCHES == before


def test_plain_k6_sums_fixed_point_weights_exactly():
    """The plain version's CDF is built from exact int64 prefix sums of
    the weights in 38-bit fixed point, in float32 times the total's
    reciprocal, clamped to 1, its last entry 1: the CDF the kernel builds
    in any summation order. A weight below 2^-39 of the row's largest
    counts as 0."""
    rng = np.random.default_rng(12)
    batch, k = 3, 50000
    logw = _t((rng.normal(size=(batch, k)) * 3).astype(np.float32))
    pos = _t(_positions(batch, k, "stratified", 13))
    w = torch.exp(logw - logw.max(dim=1, keepdim=True).values).numpy()
    fixed = np.round(w.astype(np.float64) * 2.0 ** 38).astype(np.int64)
    cum = np.cumsum(fixed, axis=1).astype(np.float32)
    cdf = np.minimum(cum * (np.float32(1) / cum[:, -1:]), np.float32(1))
    cdf[:, -1] = 1
    assert (np.diff(cdf, axis=1) >= 0).all() and (cdf[:, -1] == 1).all()
    want = np.minimum(
        np.stack([np.searchsorted(c, p, side="right")
                  for c, p in zip(cdf, pos.numpy())]), k - 1)
    np.testing.assert_array_equal(
        searchsorted_cdf_cuda.searchsorted_cdf(logw, pos).numpy(), want)
    tiny = torch.tensor([[-30.0, 0.0]])     # exp(-30) < 2^-39
    at_zero = torch.zeros(1, 1)
    assert searchsorted_cdf_cuda.searchsorted_cdf(tiny, at_zero).item() == 1


def test_plain_k6_against_jax_cdf_at_large_k():
    """The fixed-point CDF against the JAX package's float32 CDF
    (`_normalized_cumsum`, XLA) and search at K = 100,000, the largest K
    at which float32 prefix sums stay within the JAX package's bound of an
    exact sum on these weights. One deviation by design: a weight below
    2^-39 of the row's largest counts as 0 in the port, so a position
    below it picks the next particle, where the JAX package picks it."""
    batch, k = 2, 100000
    logw = _log_weights(k, batch, k)
    pos = _positions(batch, k, "systematic", k + 1)
    cdf = np.asarray(jax_resampling._normalized_cumsum(jnp.asarray(logw)))
    want = np.minimum(np.stack([np.searchsorted(c, p, side="right")
                                for c, p in zip(cdf, pos)]), k - 1)
    _assert_within_bound(
        searchsorted_cdf_cuda.searchsorted_cdf(_t(logw), _t(pos)).numpy(),
        want)
    tiny = np.array([[-30.0, 0.0]], np.float32)     # exp(-30) < 2^-39
    at_zero = np.zeros((1, 1), np.float32)
    jax_cdf = np.asarray(jax_resampling._normalized_cumsum(jnp.asarray(tiny)))
    assert np.searchsorted(jax_cdf[0], 0.0, side="right") == 0
    assert searchsorted_cdf_cuda.searchsorted_cdf(_t(tiny),
                                                  _t(at_zero)).item() == 1
