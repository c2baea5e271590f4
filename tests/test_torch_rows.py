"""Every kernel wrapper of the port takes more than 65,535 batch rows.

The kernels spread rows over the grid's second and third dimensions (K6
a cluster a row over its first), so their wrappers no longer cap B at
65,535, the limit of one grid dimension. On the CPU each wrapper runs its plain version;
here each gets B = 65,537 rows of K = 4 particles and is held against the
JAX package's XLA route (its CDF and `_searchsorted_right`) or numpy on
the same inputs. The Pallas interpreter would take minutes at this B.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from aesmc_tpu import resampling as jax_resampling
from aesmc_tpu_torch.ops import (gather_sorted_cuda, range_sum_cuda,
                                 resample_cuda, resample_sorted_cuda,
                                 searchsorted_cdf_cuda,
                                 searchsorted_sorted_cuda)
from torch_replay import tensor as _t

B, K = 65537, 4
# The JAX package's bound on index differences from a CDF summed in
# another order (tests/test_resample_pallas.py:39-49).
MISMATCH_FRACTION, MISMATCH_DISTANCE = 0.005, 3


def _inputs(seed):
    """Log-weights with a row of all mass on one particle, the JAX
    package's CDF of them, stratified positions, values and integer
    cotangents."""
    rng = np.random.default_rng(seed)
    logw = (rng.normal(size=(B, K)) * 2).astype(np.float32)
    logw[-1] = -np.inf
    logw[-1, 2] = 0.0
    cdf = np.asarray(jax_resampling._normalized_cumsum(jnp.asarray(logw)))
    pos = ((np.arange(K) + rng.uniform(size=(B, K))) / K).astype(np.float32)
    pos = np.minimum(pos, np.nextafter(np.float32(1), np.float32(0)))
    value = rng.normal(size=(B, K, 2)).astype(np.float32)
    g = rng.integers(-5, 6, size=(B, K, 2)).astype(np.float32)
    return logw, cdf, pos, value, g


def _search(cdf, pos):
    """The JAX package's XLA search, clamped to K - 1."""
    idx = jax_resampling._searchsorted_right(jnp.asarray(cdf),
                                             jnp.asarray(pos))
    return np.minimum(np.asarray(idx), cdf.shape[1] - 1)


def _gather(value, idx):
    return np.take_along_axis(value, idx[:, :, None].astype(np.int64), 1)


def _k1():
    logw, cdf, _, value, _ = _inputs(1)
    u = np.random.default_rng(2).uniform(size=(B, 1)).astype(np.float32)
    pos = resample_cuda.systematic_positions(_t(u), K).numpy()
    idx, out = resample_cuda.resample_and_gather_systematic(
        _t(cdf), _t(u), _t(value))
    want = _search(cdf, pos)
    np.testing.assert_array_equal(idx.numpy(), want)
    np.testing.assert_array_equal(out.numpy(), _gather(value, want))


def _k2():
    _, cdf, pos, _, g = _inputs(3)
    got = range_sum_cuda.range_sum(_t(cdf), _t(pos), _t(g))
    src = _search(cdf, pos)
    want = np.einsum("bjk,bjc->bkc", np.eye(K, dtype=np.float32)[src], g)
    np.testing.assert_array_equal(got.numpy(), want)


def _k3():
    _, cdf, pos, value, _ = _inputs(4)
    idx, out = resample_sorted_cuda.resample_and_gather_sorted(
        _t(cdf), _t(pos), _t(value))
    want = _search(cdf, pos)
    np.testing.assert_array_equal(idx.numpy(), want)
    np.testing.assert_array_equal(out.numpy(), _gather(value, want))


def _k4():
    _, cdf, pos, _, _ = _inputs(5)
    got = searchsorted_sorted_cuda.searchsorted_sorted(_t(cdf), _t(pos))
    np.testing.assert_array_equal(got.numpy(), _search(cdf, pos))


def _k5():
    rng = np.random.default_rng(6)
    value = rng.integers(-2 ** 31, 2 ** 31, size=(B, K)).astype(np.int32)
    idx = np.sort(rng.integers(-1, K + 1, size=(B, K)), axis=1).astype(
        np.int32)
    got = gather_sorted_cuda.gather_sorted(_t(value), _t(idx))
    want = np.take_along_axis(value, np.clip(idx, 0, K - 1), 1)
    np.testing.assert_array_equal(got.numpy(), want)


def _k6():
    logw, cdf, pos, value, _ = _inputs(7)
    idx, out = searchsorted_cdf_cuda.searchsorted_cdf(
        _t(logw), _t(pos), _t(value))
    want = _search(cdf, pos)
    got = idx.numpy()
    assert (got != want).mean() < MISMATCH_FRACTION
    assert np.abs(got.astype(np.int64) - want).max() <= MISMATCH_DISTANCE
    np.testing.assert_array_equal(got[-1], want[-1])  # one particle
    np.testing.assert_array_equal(out.numpy(), _gather(value, got))


@pytest.mark.parametrize("check", [_k1, _k2, _k3, _k4, _k5, _k6],
                         ids=["K1", "K2", "K3", "K4", "K5", "K6"])
def test_wrapper_takes_more_than_65535_rows(check):
    check()
