"""The port's EKF/UKF proposals (`aesmc_tpu_torch.proposals`) against the
JAX package's, on the same numpy inputs.

Nonlinear means (a tanh transition, a sine emission; in vector mode a
coupled 3 -> 2 map), scalar and vector mode, extended and unscented, at
t = 0 and t >= 1. On a linear model the extended proposal is the exact
locally-optimal one (the closed form of `tests/test_proposals.py`).

Tolerances: loc and scale (scalar mode) or scale_tril (vector mode) within
1e-5 absolute, float32 batched algebra against a per-particle map of the
same formula (products and Cholesky factors rounded in another order);
the closed forms within 1e-5 relative, as the JAX tests hold them. A
non-positive-definite covariance gives NaN in both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (caps PyTorch's threads)
from aesmc_tpu import proposals as jax_proposals
from aesmc_tpu_torch import inference, proposals
from aesmc_tpu_torch.state import BatchShapeMode

B, K, T = 2, 5, 4
A, QS, C, RS = 0.9, 1.0, 1.3, 0.5
ATOL = 1e-5


def _scalar(pkg, lib, linearization, linear=False):
    if linear:
        f, g = (lambda x: A * x), (lambda x: C * x)
    else:
        f = lambda x: 0.5 * x + 2.0 * lib.tanh(x)  # noqa: E731
        g = lambda x: x + 0.2 * lib.sin(x)  # noqa: E731
    return pkg.ekf_proposal(
        transition_mean=f, transition_cov=QS ** 2, emission_mean=g,
        emission_cov=RS ** 2, initial_mean=0.0, initial_cov=1.0,
        linearization=linearization)


Q3 = np.array([[0.5, 0.1, 0.0], [0.1, 0.4, 0.05], [0.0, 0.05, 0.3]],
              np.float32)
R2 = np.array([[0.09, 0.01], [0.01, 0.16]], np.float32)
P0 = np.eye(3, dtype=np.float32) * 0.8
M0 = np.array([0.1, -0.2, 0.3], np.float32)


def _vector_means(lib, stack):
    """A coupled transition mean [3] -> [3] and emission mean [3] -> [2]."""
    def f(x):
        return 0.9 * x + 0.3 * lib.sin(x[..., ::-1] if lib is jnp
                                       else x.flip(-1))

    def g(x):
        return stack([x[0] * x[1] + x[2], lib.tanh(x[1]) - 0.5 * x[2]])

    return f, g


def _vector(pkg, lib, linearization, stack):
    f, g = _vector_means(lib, stack)
    return pkg.ekf_proposal(
        transition_mean=f, transition_cov=Q3, emission_mean=g,
        emission_cov=R2, initial_mean=M0, initial_cov=P0,
        linearization=linearization)


def _inputs(shape_x, shape_y, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(*shape_x).astype(np.float32),
            rng.randn(*shape_y).astype(np.float32))


def _both(jax_prop, prop, x_prev, obs, t):
    obs_seq = inference.ObservationSequence(torch.tensor(obs))
    if t == 0:
        want = jax_prop(time=0, observations=jnp.asarray(obs))
        got = prop(time=0, observations=obs_seq)
    else:
        want = jax_prop(previous_latents=[jnp.asarray(x_prev)], time=t,
                        observations=jnp.asarray(obs))
        got = prop(previous_latents=[torch.tensor(x_prev)],
                   time=inference.TimeIndex(t), observations=obs_seq)
    assert got.batch_shape_mode.name == want.batch_shape_mode.name
    return want, got


@pytest.mark.parametrize("t", [0, 2])
@pytest.mark.parametrize("linearization", ["extended", "unscented"])
def test_scalar_mode_matches_jax(linearization, t):
    x_prev, obs = _inputs((B, K), (T, B))
    want, got = _both(_scalar(jax_proposals, jnp, linearization),
                      _scalar(proposals, torch, linearization), x_prev, obs,
                      t)
    np.testing.assert_allclose(got.loc.numpy(), np.asarray(want.loc),
                               atol=ATOL)
    np.testing.assert_allclose(got.scale.numpy(), np.asarray(want.scale),
                               atol=ATOL)


@pytest.mark.parametrize("t", [0, 1])
@pytest.mark.parametrize("linearization", ["extended", "unscented"])
def test_vector_mode_matches_jax(linearization, t):
    x_prev, obs = _inputs((B, K, 3), (T, B, 2), seed=1)
    want, got = _both(_vector(jax_proposals, jnp, linearization, jnp.stack),
                      _vector(proposals, torch, linearization, torch.stack),
                      x_prev, obs, t)
    np.testing.assert_allclose(got.loc.numpy(), np.asarray(want.loc),
                               atol=ATOL)
    np.testing.assert_allclose(got.scale_tril.numpy(),
                               np.asarray(want.scale_tril), atol=ATOL)


@pytest.mark.parametrize("linearization", ["extended", "unscented"])
def test_linear_model_is_the_optimal_proposal(linearization):
    x_prev, obs = _inputs((B, K), (T, B), seed=2)
    prop = _scalar(proposals, torch, linearization, linear=True)
    d = prop(previous_latents=[torch.tensor(x_prev)],
             time=inference.TimeIndex(2),
             observations=inference.ObservationSequence(torch.tensor(obs)))
    var_opt = 1.0 / (1.0 / QS ** 2 + C ** 2 / RS ** 2)
    loc_opt = var_opt * (A * x_prev / QS ** 2 + C * obs[2][:, None] / RS ** 2)
    np.testing.assert_allclose(d.loc.numpy(), loc_opt, rtol=1e-5)
    np.testing.assert_allclose(d.scale.numpy(),
                               np.full((B, K), np.sqrt(var_opt)), rtol=1e-5)
    assert d.batch_shape_mode == BatchShapeMode.FULLY_EXPANDED


def test_callable_covariances_match_jax():
    """State-dependent noise: covariance callables, mapped per particle."""
    x_prev, obs = _inputs((B, K, 3), (T, B, 2), seed=3)

    def build(pkg, lib, stack):
        f, g = _vector_means(lib, stack)
        return pkg.ekf_proposal(
            f, lambda x: lib.asarray(Q3) * (1.0 + 0.1 * (x * x).sum()), g,
            lambda x: lib.asarray(R2) * (1.0 + 0.2 * lib.tanh(x[0]) ** 2),
            M0, P0)

    want, got = _both(build(jax_proposals, jnp, jnp.stack),
                      build(proposals, torch, torch.stack), x_prev, obs, 1)
    np.testing.assert_allclose(got.loc.numpy(), np.asarray(want.loc),
                               atol=ATOL)
    np.testing.assert_allclose(got.scale_tril.numpy(),
                               np.asarray(want.scale_tril), atol=ATOL)


def test_not_positive_definite_gives_nan_as_jax():
    """An emission covariance that is not positive definite: the factor of
    S is NaN, and so is the proposal, in both packages."""
    bad = np.array([[1.0, 2.0], [2.0, 1.0]], np.float32) * -1.0

    def build(pkg, lib, stack):
        return pkg.ekf_proposal(
            lambda x: x, np.eye(2, dtype=np.float32) * 1e-3,
            lambda x: x, bad, np.zeros(2, np.float32),
            np.eye(2, dtype=np.float32) * 1e-3)

    x_prev, obs = _inputs((B, K, 2), (T, B, 2), seed=4)
    want, got = _both(build(jax_proposals, jnp, jnp.stack),
                      build(proposals, torch, torch.stack), x_prev, obs, 1)
    np.testing.assert_array_equal(np.isnan(got.loc.numpy()),
                                  np.isnan(np.asarray(want.loc)))
    assert np.isnan(got.loc.numpy()).all()


def test_validation():
    with pytest.raises(ValueError, match="linearization"):
        proposals.ekf_proposal(lambda x: x, 1.0, lambda x: x, 1.0, 0.0, 1.0,
                               linearization="bogus")


def test_host_read_in_a_mean_function_raises():
    """The documented contract: mean functions are pure tensor functions;
    `torch.func.vmap` refuses a host read where `jax.vmap` would trace."""
    prop = proposals.ekf_proposal(
        lambda x: x * float(x.item() > 0), 1.0, lambda x: x, 1.0, 0.0, 1.0)
    x_prev, obs = _inputs((B, K), (T, B))
    with pytest.raises(RuntimeError):
        prop(previous_latents=[torch.tensor(x_prev)],
             time=inference.TimeIndex(1),
             observations=inference.ObservationSequence(torch.tensor(obs)))
