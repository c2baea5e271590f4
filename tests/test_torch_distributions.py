"""The port's distributions and `state.sample`'s noise kinds, against the
JAX package.

Each distribution is built in both packages from the same numpy
parameters. The JAX package draws from a key; the port takes the same
draw as its noise (`jax.random.normal`, `uniform` or `gumbel` of the key,
in the shape the JAX distribution draws it), so that `rsample` (or, for
the discrete ones, `sample`) maps the same noise to the same value. Then
`log_prob` of that value and `mean` are compared. `state.sample` is held
to the JAX package's on the three batch-shape modes with the JAX draws
replayed through a `ReplayNoise`.

Tolerances: draws within 1e-6 (relative and absolute; the same float32
arithmetic up to fused operations), log-probabilities and means within
1e-5 (log, expm1 and triangular solves round differently).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aesmc_tpu import distributions as jax_dists
from aesmc_tpu import state as jax_state
from aesmc_tpu_torch import distributions as dists
from aesmc_tpu_torch import state
from aesmc_tpu_torch.state import BatchShapeMode
from aesmc_tpu.state import BatchShapeMode as JaxMode
from torch_replay import ReplayNoise, tensor

SAMPLE_SHAPE = (4,)
RNG = np.random.RandomState(0)
LOC = RNG.randn(3, 2).astype(np.float32)
SCALE = (0.5 + RNG.rand(3, 2)).astype(np.float32)
TRIL = np.tril(RNG.randn(3, 2, 2)).astype(np.float32)
TRIL[:, range(2), range(2)] = np.abs(TRIL[:, range(2), range(2)]) + 0.5
COV = np.array([[1.5, 0.3], [0.3, 0.8]], np.float32)
LOGITS = RNG.randn(3, 4).astype(np.float32)


def _pair(name):
    """(JAX distribution, port distribution, noise kind or None)."""
    j, t = jnp.asarray, tensor
    if name == "normal":
        return (jax_dists.Normal(j(LOC), j(SCALE)),
                dists.Normal(t(LOC), t(SCALE)), "normal")
    if name == "mvn_diag":
        return (jax_dists.MultivariateNormalDiag(j(LOC), j(SCALE)),
                dists.MultivariateNormalDiag(t(LOC), t(SCALE)), "normal")
    if name == "mvn_tril":
        return (jax_dists.MultivariateNormalTriL(j(LOC), j(TRIL)),
                dists.MultivariateNormalTriL(t(LOC), t(TRIL)), "normal")
    if name == "mvn_covariance":
        return (jax_dists.MultivariateNormalTriL.from_covariance(j(LOC),
                                                                 j(COV)),
                dists.MultivariateNormalTriL.from_covariance(t(LOC), t(COV)),
                "normal")
    if name == "independent":
        return (jax_dists.Independent(jax_dists.Normal(j(LOC), j(SCALE)), 1),
                dists.Independent(dists.Normal(t(LOC), t(SCALE)), 1),
                "normal")
    if name == "laplace":
        return (jax_dists.Laplace(j(LOC), j(SCALE)),
                dists.Laplace(t(LOC), t(SCALE)), "uniform")
    if name == "lognormal":
        return (jax_dists.LogNormal(j(LOC), j(SCALE)),
                dists.LogNormal(t(LOC), t(SCALE)), "normal")
    if name.startswith("transformed_"):
        bijector = name.split("_", 1)[1]
        return (jax_dists.TransformedDistribution(
                    jax_dists.Normal(j(LOC), j(SCALE)), bijector),
                dists.TransformedDistribution(
                    dists.Normal(t(LOC), t(SCALE)), bijector), "normal")
    if name == "uniform":
        return (jax_dists.Uniform(j(LOC), j(LOC + SCALE)),
                dists.Uniform(t(LOC), t(LOC + SCALE)), "uniform")
    if name == "deterministic":
        return (jax_dists.Deterministic(j(LOC), event_ndims=1),
                dists.Deterministic(t(LOC), event_ndims=1), None)
    if name == "bernoulli":
        return (jax_dists.Bernoulli(j(LOGITS)), dists.Bernoulli(t(LOGITS)),
                "uniform")
    if name == "one_hot":
        return (jax_dists.OneHotCategorical(j(LOGITS)),
                dists.OneHotCategorical(t(LOGITS)), "gumbel")
    raise ValueError(name)


NAMES = ["normal", "mvn_diag", "mvn_tril", "mvn_covariance", "independent",
         "laplace", "lognormal", "transformed_exp", "transformed_sigmoid",
         "transformed_tanh", "transformed_softplus", "uniform",
         "deterministic", "bernoulli", "one_hot"]


def _jax_noise(kind, key, shape):
    """The draw the JAX distribution makes from ``key``."""
    if kind == "normal":
        return jax.random.normal(key, shape, dtype=jnp.float32)
    if kind == "uniform":
        return jax.random.uniform(key, shape, dtype=jnp.float32)
    return jax.random.gumbel(key, shape, dtype=jnp.float32)


@pytest.mark.parametrize("name", NAMES)
def test_distribution_matches_jax(name):
    jax_dist, dist, kind = _pair(name)
    assert tuple(dist.batch_shape) == tuple(jax_dist.batch_shape)
    assert tuple(dist.event_shape) == tuple(jax_dist.event_shape)
    assert dist.has_rsample == jax_dist.has_rsample
    assert dist.noise_kind == kind
    key = jax.random.PRNGKey(NAMES.index(name))
    want = np.asarray(jax_dist.sample(key, SAMPLE_SHAPE))
    noise = (None if kind is None else
             tensor(_jax_noise(kind, key, dist.noise_shape(SAMPLE_SHAPE))))
    draw = dist.rsample if dist.has_rsample else dist.sample
    got = draw(SAMPLE_SHAPE, noise)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        dist.log_prob(tensor(want)).numpy(),
        np.asarray(jax_dist.log_prob(jnp.asarray(want))), rtol=1e-5,
        atol=1e-5)
    if hasattr(jax_dist, "mean"):
        np.testing.assert_allclose(dist.mean.numpy(),
                                   np.asarray(jax_dist.mean), rtol=1e-5,
                                   atol=1e-5)


def test_shared_factor_and_gradients():
    """One Cholesky factor for every batch entry takes one matmul and one
    solve; it agrees with the batched form, and its rsample carries the
    gradient of loc and the factor."""
    loc = tensor(LOC).requires_grad_()
    tril = tensor(TRIL[0]).requires_grad_()
    shared = dists.MultivariateNormalTriL(loc, tril)
    batched = dists.MultivariateNormalTriL(loc, tril.expand(3, 2, 2))
    eps = torch.randn(4, 3, 2)
    x = shared.rsample(SAMPLE_SHAPE, eps)
    np.testing.assert_allclose(x.detach().numpy(),
                               batched.rsample(SAMPLE_SHAPE, eps).detach()
                               .numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(shared.log_prob(x).detach().numpy(),
                               batched.log_prob(x).detach().numpy(),
                               rtol=1e-5, atol=1e-5)
    x.sum().backward()
    assert loc.grad is not None and tril.grad is not None
    with pytest.raises(ValueError, match="eps has shape"):
        shared.rsample(SAMPLE_SHAPE, torch.zeros(4, 3))
    with pytest.raises(ValueError, match="bijector"):
        dists.TransformedDistribution(shared, "cube")


@pytest.mark.parametrize("name,mode", [
    ("laplace", "batch_expanded"), ("bernoulli", "batch_expanded"),
    ("one_hot", "not_expanded"), ("uniform", "fully_expanded"),
    ("deterministic", "fully_expanded"), ("mvn_tril", "batch_expanded"),
])
def test_state_sample_matches_jax(name, mode):
    batch, k = 3, 5
    j, t = jnp.asarray, tensor
    loc = {"not_expanded": LOC[0, 0], "batch_expanded": LOC[:, 0],
           "fully_expanded": np.repeat(LOC[:, :1], k, axis=1)}[mode]
    if name == "laplace":
        pair = (jax_dists.Laplace(j(loc), 0.7), dists.Laplace(t(loc), 0.7))
    elif name == "bernoulli":
        pair = (jax_dists.Bernoulli(j(loc)), dists.Bernoulli(t(loc)))
    elif name == "one_hot":
        pair = (jax_dists.OneHotCategorical(j(LOGITS[0])),
                dists.OneHotCategorical(t(LOGITS[0])))
    elif name == "uniform":
        pair = (jax_dists.Uniform(j(loc), j(loc + 1.0)),
                dists.Uniform(t(loc), t(loc + 1.0)))
    elif name == "deterministic":
        pair = (jax_dists.Deterministic(j(loc)), dists.Deterministic(t(loc)))
    else:
        pair = (jax_dists.MultivariateNormalTriL(j(LOC), j(TRIL)),
                dists.MultivariateNormalTriL(t(LOC), t(TRIL)))
    jax_mode, port_mode = (getattr(JaxMode, mode.upper()),
                           getattr(BatchShapeMode, mode.upper()))
    jax_dist = jax_state.set_batch_shape_mode(pair[0], jax_mode)
    dist = pair[1]
    dist.batch_shape_mode = port_mode
    key = jax.random.PRNGKey(30)
    want = np.asarray(jax_state.sample(jax_dist, batch, k, key))
    sample_shape = {"not_expanded": (batch, k), "batch_expanded": (k,),
                    "fully_expanded": ()}[mode]
    kind = dist.noise_kind
    draws = {}
    if kind is not None:
        draw = _jax_noise(kind, key, dist.noise_shape(sample_shape))
        if dist.has_rsample and mode == "batch_expanded":
            # A reparameterized draw is made in the [batch, particle, ...]
            # layout, the JAX draw in [particle, batch, ...].
            draw = jnp.swapaxes(draw, 0, 1)
        draws = {kind + "s": [draw]}
    noise = ReplayNoise(**draws)
    got = state.sample(dist, batch, k, noise)
    assert noise.exhausted()
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        state.log_prob(dist, got).numpy(),
        np.asarray(jax_state.log_prob(jax_dist, jnp.asarray(want))),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("covariance", [
    COV,                                                    # positive definite
    np.array([[1.0, 2.0], [2.0, 1.0]], np.float32),         # indefinite
    np.array([[[1.0, 0.0], [0.0, 1.0]],
              [[4.0, 2.0], [2.0, 1.0]]], np.float32),       # one singular
])
def test_from_covariance_factor_matches_jax(covariance):
    """`from_covariance`'s factor is `jnp.linalg.cholesky`'s: the same
    factor where the matrix is positive definite (within 1e-6), and NaN on
    and below the diagonal, zeros above, where it is not. The port reads
    no error flag on the host (`cholesky_ex`)."""
    loc = np.zeros(covariance.shape[:-1], np.float32)
    got = dists.MultivariateNormalTriL.from_covariance(
        tensor(loc), tensor(covariance)).scale_tril.numpy()
    want = np.asarray(jax_dists.MultivariateNormalTriL.from_covariance(
        jnp.asarray(loc), jnp.asarray(covariance)).scale_tril)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_array_equal(np.isnan(got),
                                  np.isnan(np.asarray(
                                      jnp.linalg.cholesky(covariance))))


@pytest.mark.parametrize("n, m", [(1, 1), (4, 4), (9, 9), (9, 2)])
def test_cho_solve_matches_jax(n, m):
    """`cho_solve` (two triangular solves) against the JAX package's
    `jax.scipy.linalg.cho_solve` on a batch of positive-definite float32
    matrices (within 1e-5 relative), and against `np.linalg.solve` in
    float64 (within 1e-10)."""
    rng = np.random.RandomState(n + m)
    a = rng.randn(3, n, n)
    spd = a @ a.transpose(0, 2, 1) + n * np.eye(n)
    rhs = rng.randn(3, n, m)
    got = dists.cho_solve(dists.cholesky(torch.tensor(spd)),
                          torch.tensor(rhs)).numpy()
    np.testing.assert_allclose(got, np.linalg.solve(spd, rhs), rtol=1e-10,
                               atol=1e-10)
    spd32, rhs32 = spd.astype(np.float32), rhs.astype(np.float32)
    got32 = dists.cho_solve(dists.cholesky(tensor(spd32)),
                            tensor(rhs32)).numpy()
    want32 = jax.vmap(lambda s, r: jax.scipy.linalg.cho_solve(
        (jnp.linalg.cholesky(s), True), r))(spd32, rhs32)
    np.testing.assert_allclose(got32, np.asarray(want32), rtol=1e-5,
                               atol=1e-6)
