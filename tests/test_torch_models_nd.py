"""The D-dimensional LGSSM, its exact Kalman oracle and the
stochastic-volatility model in the port, against the JAX package.

`lgssm_nd.from_numpy` and `stochastic_volatility.from_numpy` carry the
JAX components' fields across; both packages filter the same
observations at a small size (T = 6, K = 32, D = 3), with the JAX run's
draws replayed into the port (eps recovered from its latents by the
port's own proposal, the resampling uniforms redrawn from its keys) and
the JAX package's CDF patched in, so that the ancestors compare exactly.
The port's `kalman_nd` is the JAX package's numpy oracle copied, and the
port's filter with the exact proposal (`lgssm_nd.optimal_proposal`) is
held to it.

Tolerances: ancestors exactly equal; log-Z, weights and latents within
1e-4 absolute; `kalman_nd` within 1e-10 (the same float64 arithmetic);
the filter with the exact proposal within 1% of the exact log-Z.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aesmc_tpu import inference as jax_inference
from aesmc_tpu import resampling as jax_resampling
from aesmc_tpu import statistics as jax_statistics
from aesmc_tpu.models import kalman_nd as jax_kalman_nd
from aesmc_tpu.models import lgssm_nd as jax_lgssm_nd
from aesmc_tpu.models import stochastic_volatility as jax_sv
from aesmc_tpu_torch import inference, resampling, statistics
from aesmc_tpu_torch.models import kalman_nd, lgssm_nd
from aesmc_tpu_torch.models import stochastic_volatility as sv
from aesmc_tpu_torch.noise import NoiseSource
from torch_replay import (ReplayNoise, fields, proposal_eps,
                          resampling_draws, tensor)

T, B, K, DIM = 6, 2, 32, 3
CPU = "cpu"
KEY = jax.random.PRNGKey(0)


@pytest.fixture
def jax_cdf(monkeypatch):
    def cdf(log_weight):
        return tensor(jax_resampling._normalized_cumsum(
            jnp.asarray(log_weight.detach().numpy())))

    monkeypatch.setattr(resampling, "_normalized_cumsum", cdf)


def _params(jax_comps):
    return dict(zip(("initial", "transition", "emission", "proposal"),
                    (fields(c) for c in jax_comps)))


def test_kalman_nd_matches_jax():
    rng = np.random.RandomState(1)
    d, do = 3, 2
    params = dict(initial_mean=rng.randn(d), initial_cov=np.eye(d) * 1.3,
                  transition_matrix=rng.randn(d, d) * 0.4,
                  transition_cov=np.diag(rng.rand(d) + 0.2),
                  emission_matrix=rng.randn(do, d),
                  emission_cov=np.diag(rng.rand(do) + 0.1))
    obs = rng.randn(10, do)
    want = jax_kalman_nd.kalman_filter_nd(
        obs, jax_kalman_nd.KalmanNdParams(**params))
    got = kalman_nd.kalman_filter_nd(obs, kalman_nd.KalmanNdParams(**params))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-10)
    for a, b in zip(kalman_nd.kalman_smoother_nd(
            obs, kalman_nd.KalmanNdParams(**params)),
            jax_kalman_nd.kalman_smoother_nd(
                obs, jax_kalman_nd.KalmanNdParams(**params))):
        np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-10)


def _filter_both(jax_comps, comps, obs, key):
    want = jax_inference.infer(
        "smc", jnp.asarray(obs), *jax_comps, K, key=key,
        return_log_marginal_likelihood=True, return_original_latents=True,
        return_ancestral_indices=True, return_log_weights=True)
    eps = proposal_eps(comps[3], obs, want["original_latents"],
                       want["ancestral_indices"])
    noise = ReplayNoise(normals=eps, **resampling_draws(key, T, B, K,
                                                        "systematic"))
    with torch.no_grad():
        got = inference.infer(
            "smc", tensor(obs), *comps, K, noise=noise,
            return_log_marginal_likelihood=True,
            return_original_latents=True, return_ancestral_indices=True,
            return_log_weights=True)
    assert noise.exhausted()
    np.testing.assert_array_equal(got["ancestral_indices"].numpy(),
                                  np.asarray(want["ancestral_indices"]))
    for name in ("log_marginal_likelihood", "log_weights",
                 "original_latents", "latents"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   rtol=0, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("train_scale", [False, True])
def test_lgssm_nd_filter_matches_jax(train_scale, jax_cdf):
    initial, transition, emission, proposal = jax_lgssm_nd.make_model(
        dim=DIM, key=KEY, transition_scale=0.7, emission_scale=0.5)
    if train_scale:
        transition = jax_lgssm_nd.Transition.create(
            transition.matrix, [0.7, 0.6, 0.8], train_scale=True)
    jax_comps = (initial, transition, emission, proposal)
    comps = lgssm_nd.from_numpy(_params(jax_comps), device=CPU)
    assert (comps[1].scale is not None) == train_scale
    _, obs = jax_statistics.sample_from_prior(*jax_comps[:3], T, B, KEY)
    _filter_both(jax_comps, comps, np.asarray(obs),
                 jax.random.PRNGKey(2))


def test_stochastic_volatility_filter_matches_jax(jax_cdf):
    jax_comps = jax_sv.make_model()
    comps = sv.from_numpy(_params(jax_comps), device=CPU)
    _, obs = jax_statistics.sample_from_prior(*jax_comps[:3], T, B, KEY)
    _filter_both(jax_comps, comps, np.asarray(obs), jax.random.PRNGKey(3))
    ref = sv.make_model(device=CPU)
    for a, b in zip(ref, comps):
        for (name, p), q in zip(a.named_parameters(), b.parameters()):
            np.testing.assert_allclose(p.detach().numpy(),
                                       q.detach().numpy(), rtol=1e-6,
                                       err_msg=name)


def test_optimal_proposal_filter_matches_kalman_nd():
    comps = lgssm_nd.make_model(dim=DIM, seed=4, emission_scale=0.3,
                                device=CPU)
    noise = NoiseSource.seeded(5, CPU)
    with torch.no_grad():
        _, obs = statistics.sample_from_prior(*comps[:3], 8, 1, noise)
    exact = kalman_nd.kalman_filter_nd(
        obs[:, 0].numpy(), lgssm_nd.kalman_params(*comps[:3]))[4]
    optimal = lgssm_nd.optimal_proposal(*comps[:3])
    with torch.no_grad():
        est = inference.infer(
            "smc", obs, *comps[:3], optimal, 512, noise=noise,
            return_log_marginal_likelihood=True,
            return_latents=False)["log_marginal_likelihood"]
    assert abs(float(est[0]) - exact) < 0.01 * abs(exact), (est, exact)
