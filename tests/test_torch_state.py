"""The port's math, Normal and state algebra against the JAX package.

Inputs are made from a numpy seed; sampling gets the JAX package's own
standard-normal draws, replayed through the port's noise seam. Values agree
within 1e-6: both sides compute the same float32 expressions, and exp/log
may differ in the last bits between the two libraries.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aesmc_tpu import distributions as jax_dists
from aesmc_tpu import math as jax_math
from aesmc_tpu import state as jax_state
from aesmc_tpu_torch import distributions, math, state
from aesmc_tpu_torch.noise import NoiseSource

TOL = dict(rtol=1e-6, atol=1e-6)
B, K = 3, 5


def _t(x):
    return torch.tensor(np.asarray(x))


class ReplayNormals:
    """A noise source that hands out given standard-normal draws."""

    def __init__(self, *eps):
        self.eps = [_t(e) for e in eps]

    def normal(self, shape):
        eps = self.eps.pop(0)
        assert tuple(shape) == tuple(eps.shape)
        return eps


@pytest.mark.parametrize("dim", [0, 1, -1])
def test_math_matches_jax(dim):
    x = np.random.RandomState(0).randn(4, 6).astype(np.float32) * 5
    x[1, 2] = -np.inf
    for name in ("lognormexp", "exponentiate_and_normalize"):
        want = np.asarray(getattr(jax_math, name)(jnp.asarray(x), dim=dim))
        got = getattr(math, name)(_t(x), dim=dim).numpy()
        np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(
        math.logsumexp(_t(x), axis=dim).numpy(),
        np.asarray(jax_math.logsumexp(jnp.asarray(x), axis=dim)), **TOL)
    np.testing.assert_allclose(
        math.logsumexp(_t(x)).numpy(),
        np.asarray(jax_math.logsumexp(jnp.asarray(x))), **TOL)


def test_normal_log_prob_matches_jax():
    rng = np.random.RandomState(1)
    loc = rng.randn(B, K).astype(np.float32)
    scale = rng.uniform(0.2, 2.0, size=(B, K)).astype(np.float32)
    value = rng.randn(B, K).astype(np.float32) * 3
    for lo, sc in ((loc, scale), (0.5, 1.7), (loc, 0.3)):
        want = np.asarray(jax_dists.Normal(lo, sc).log_prob(
            jnp.asarray(value)))
        got = distributions.Normal(
            _t(lo) if isinstance(lo, np.ndarray) else lo,
            _t(sc) if isinstance(sc, np.ndarray) else sc
        ).log_prob(_t(value)).numpy()
        np.testing.assert_allclose(got, want, **TOL)
    assert distributions.Normal(_t(loc), 0.3).batch_shape == (B, K)
    assert distributions.Normal(0.0, 1.0).batch_shape == ()


def _pair(mode, rng):
    """The same Normal in both packages, in one batch-shape mode."""
    if mode == "NOT_EXPANDED":
        loc, scale = 0.7, 1.3
        return (jax_dists.Normal(loc, scale),
                distributions.Normal(loc, scale))
    if mode == "BATCH_EXPANDED":
        loc = rng.randn(B).astype(np.float32)
        return (jax_dists.Normal(
                    jnp.asarray(loc), 0.4,
                    batch_shape_mode=jax_state.BatchShapeMode.BATCH_EXPANDED),
                distributions.Normal(
                    _t(loc), 0.4,
                    batch_shape_mode=state.BatchShapeMode.BATCH_EXPANDED))
    loc = rng.randn(B, K).astype(np.float32)
    return (jax_dists.Normal(
                jnp.asarray(loc), 0.4,
                batch_shape_mode=jax_state.BatchShapeMode.FULLY_EXPANDED),
            distributions.Normal(
                _t(loc), 0.4,
                batch_shape_mode=state.BatchShapeMode.FULLY_EXPANDED))


@pytest.mark.parametrize(
    "mode", ["NOT_EXPANDED", "BATCH_EXPANDED", "FULLY_EXPANDED"])
def test_sample_and_log_prob_match_jax(mode):
    rng = np.random.RandomState(2)
    jax_d, torch_d = _pair(mode, rng)
    key = jax.random.PRNGKey(3)
    want = np.asarray(jax_state.sample(jax_d, B, K, key))
    # The draw JAX made, in its distribution layout, then in the port's
    # [batch, particle] layout (BATCH_EXPANDED samples [K, B] and swaps).
    sample_shape = {"NOT_EXPANDED": (B, K), "BATCH_EXPANDED": (K,),
                    "FULLY_EXPANDED": ()}[mode]
    eps = np.asarray(jax.random.normal(
        key, sample_shape + tuple(jax_d.batch_shape)))
    if mode == "BATCH_EXPANDED":
        eps = eps.swapaxes(0, 1)
    got = state.sample(torch_d, B, K, ReplayNormals(eps))
    assert tuple(got.shape) == (B, K)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert state.get_batch_shape_mode(torch_d, B, K).name == mode

    value = rng.randn(B, K).astype(np.float32)
    want_lp = np.asarray(jax_state.log_prob(jax_d, jnp.asarray(value)))
    got_lp = state.log_prob(torch_d, _t(value))
    assert tuple(got_lp.shape) == (B, K)
    np.testing.assert_allclose(got_lp.numpy(), want_lp, **TOL)


def test_event_dims_are_summed_and_dicts_add():
    rng = np.random.RandomState(4)
    loc = rng.randn(B, K, 2).astype(np.float32)
    value = rng.randn(B, K, 2).astype(np.float32)
    jax_d = jax_dists.Normal(jnp.asarray(loc), 0.9)
    torch_d = distributions.Normal(_t(loc), 0.9)
    want = np.asarray(jax_state.log_prob(jax_d, jnp.asarray(value)))
    got = state.log_prob(torch_d, _t(value)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    both = state.log_prob({"a": torch_d, "b": torch_d},
                          {"a": _t(value), "b": _t(value)}).numpy()
    np.testing.assert_allclose(both, 2 * got, **TOL)


def test_inferred_mode_warns_when_ambiguous():
    d = distributions.Normal(torch.zeros(B), 1.0)
    with pytest.warns(RuntimeWarning, match="batch_shape_mode"):
        assert state.get_batch_shape_mode(d, B, K) == \
            state.BatchShapeMode.BATCH_EXPANDED
    assert state.get_batch_shape_mode(
        distributions.Normal(torch.zeros(7), 1.0), B, K) == \
        state.BatchShapeMode.NOT_EXPANDED


def test_resample_and_expand_match_jax():
    rng = np.random.RandomState(5)
    value = rng.randn(B, K, 2).astype(np.float32)
    idx = np.sort(rng.randint(0, K, size=(B, K)), axis=1).astype(np.int32)
    want = np.asarray(jax_state.resample(jnp.asarray(value),
                                         jnp.asarray(idx)))
    got = state.resample({"v": _t(value)}, _t(idx))["v"].numpy()
    np.testing.assert_array_equal(got, want)
    obs = rng.randn(B, 4).astype(np.float32)
    np.testing.assert_array_equal(
        state.expand_observation(_t(obs), K).numpy(),
        np.asarray(jax_state.expand_observation(jnp.asarray(obs), K)))
    with pytest.raises(ValueError, match="ancestral_index"):
        state.resample(_t(value), _t(idx[:, :2]))


def test_default_noise_source_shapes_and_reproducibility():
    d = distributions.Normal(torch.zeros(B, K), 1.0,
                             batch_shape_mode=state.BatchShapeMode
                             .FULLY_EXPANDED)
    a = state.sample(d, B, K, NoiseSource.seeded(7, device="cpu"))
    b = state.sample(d, B, K, NoiseSource.seeded(7, device="cpu"))
    assert torch.equal(a, b) and a.dtype == torch.float32
    u = NoiseSource.seeded(7, device="cpu").uniform((B, 1))
    assert u.shape == (B, 1) and bool(((u >= 0) & (u < 1)).all())


def test_normal_with_python_number_parameters():
    """A Python-number loc or scale becomes a fill on the value's device
    (not a copy from the host): the same numbers as a float32 tensor."""
    rng = np.random.RandomState(4)
    value = rng.randn(B, K).astype(np.float32)
    want = np.asarray(jax_dists.Normal(0.3, 0.7).log_prob(jnp.asarray(value)))
    got = distributions.Normal(0.3, 0.7).log_prob(_t(value))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    same = distributions.Normal(torch.tensor(0.3), torch.tensor(0.7))
    assert torch.equal(same.log_prob(_t(value)), got)
    eps = rng.randn(B, K).astype(np.float32)
    assert torch.equal(distributions.Normal(0.3, 0.7).rsample((B, K),
                                                              _t(eps)),
                       0.3 + torch.tensor(0.7) * _t(eps))
