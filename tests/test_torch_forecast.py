"""The port's forecasting and calibration functions against the JAX
package's.

`forecast` rolls an LGSSM particle cloud (B = 3, K = 64) four steps
through both packages, with the JAX draws (`split(key, (H, 2))`: the
latents', then the observations' standard normals a step) replayed into
the port; `forecast_online` does the same from a streaming carry
(`online.OnlineFilterState`, t = 6), whose time its components read.
`weighted_quantiles` and `predictive_pit` take the same seeded samples
and weights, with ties for the PIT's midpoint rule.

Tolerances: the rolled latents and observations within 1e-5 absolute;
the quantiles exactly equal (a selection of the input samples); the PIT
values within 1e-6 (float32 sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aesmc_tpu import distributions as jax_distributions
from aesmc_tpu import forecast as jax_forecast
from aesmc_tpu import online as jax_online
from aesmc_tpu.models import lgssm as jax_lgssm
from aesmc_tpu.state import BatchShapeMode as JaxBatchShapeMode
from aesmc_tpu_torch import distributions, forecast, inference, online
from aesmc_tpu_torch.models import lgssm
from aesmc_tpu_torch.state import BatchShapeMode
from torch_replay import ReplayNoise, lgssm_params, normal_draw

B, K, H = 3, 64, 4


def test_forecast_replays_jax():
    jax_comps = (jax_lgssm.Initial(0.0, 1.0),
                 jax_lgssm.Transition.create(0.8, 0.7),
                 jax_lgssm.Emission.create(1.2, 0.4),
                 jax_lgssm.Proposal.create(1.0, 1.0, jax.random.PRNGKey(0)))
    comps = lgssm.from_numpy(lgssm_params(jax_comps), device="cpu")
    rng = np.random.RandomState(0)
    latent = rng.randn(B, K).astype(np.float32)
    log_weight = rng.randn(B, K).astype(np.float32)
    key = jax.random.PRNGKey(12)
    want = jax_forecast.forecast(jnp.asarray(latent), jnp.asarray(log_weight),
                                 jax_comps[1], jax_comps[2], H, key,
                                 start_time=5)
    keys = jax.random.split(key, (H, 2))
    noise = ReplayNoise(normals=[normal_draw(keys[h, i], (), (B, K))
                                 for h in range(H) for i in range(2)])
    with torch.no_grad():
        got = forecast.forecast(torch.tensor(latent),
                                torch.tensor(log_weight), comps[1], comps[2],
                                H, noise, start_time=5)
    assert noise.exhausted()
    assert got["latents"].shape == (H, B, K)
    np.testing.assert_allclose(got["latents"].numpy(),
                               np.asarray(want["latents"]), atol=1e-5)
    np.testing.assert_allclose(got["observations"].numpy(),
                               np.asarray(want["observations"]), atol=1e-5)
    assert torch.equal(got["log_weight"], torch.tensor(log_weight))
    with pytest.raises(ValueError, match="horizon"):
        forecast.forecast(torch.tensor(latent), torch.tensor(log_weight),
                          comps[1], comps[2], 0, noise, start_time=5)


def test_quantiles_and_pit_match_jax():
    rng = np.random.RandomState(1)
    values = rng.randn(B, K).astype(np.float32)
    values[:, :8] = np.round(values[:, :8])     # ties
    log_weight = (rng.randn(B, K) * 2.0).astype(np.float32)
    qs = [0.05, 0.25, 0.5, 0.75, 0.95]
    got = forecast.weighted_quantiles(torch.tensor(values),
                                      torch.tensor(log_weight), qs)
    want = jax_forecast.weighted_quantiles(jnp.asarray(values),
                                           jnp.asarray(log_weight), qs)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert bool((got[:, 1:] >= got[:, :-1]).all())
    realized = np.array([0.0, 1.0, values[2, 20]], np.float32)
    got = forecast.predictive_pit(torch.tensor(values),
                                  torch.tensor(log_weight),
                                  torch.tensor(realized))
    want = jax_forecast.predictive_pit(jnp.asarray(values),
                                       jnp.asarray(log_weight),
                                       jnp.asarray(realized))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    assert bool(((got >= 0) & (got <= 1)).all())


def test_forecast_online_replays_jax():
    """From a streaming carry: the particles, weights, last observation and
    time (a `DeviceTimeIndex` at t - 1 + h, here read by the transition)
    all come from the state."""
    jax_emission = jax_lgssm.Emission.create(1.2, 0.4)
    emission = lgssm.Emission(1.2, 0.4)
    seen = []

    def transition(previous_latents=None, time=None,
                   previous_observations=None):
        seen.append(int(time))
        return distributions.Normal(
            0.8 * previous_latents[-1] + 0.01 * time, 0.7,
            batch_shape_mode=BatchShapeMode.FULLY_EXPANDED)

    def jax_transition(previous_latents=None, time=None,
                       previous_observations=None):
        return jax_distributions.Normal(
            0.8 * previous_latents[-1] + 0.01 * jnp.asarray(time), 0.7,
            batch_shape_mode=JaxBatchShapeMode.FULLY_EXPANDED)

    rng = np.random.RandomState(3)
    latent = rng.randn(B, K).astype(np.float32)
    log_weight = rng.randn(B, K).astype(np.float32)
    prev_obs = rng.randn(B).astype(np.float32)
    key = jax.random.PRNGKey(13)
    jax_state = jax_online.OnlineFilterState(
        latent=jnp.asarray(latent), log_weight=jnp.asarray(log_weight),
        log_z_contrib=jnp.zeros(B), prev_observation=jnp.asarray(prev_obs),
        t=jnp.asarray(6, jnp.int32))
    want = jax_forecast.forecast_online(jax_state, jax_transition,
                                        jax_emission, H, key)
    keys = jax.random.split(key, (H, 2))
    noise = ReplayNoise(normals=[normal_draw(keys[h, i], (), (B, K))
                                 for h in range(H) for i in range(2)])
    state = online.OnlineFilterState(
        latent=torch.tensor(latent), log_weight=torch.tensor(log_weight),
        log_z_contrib=torch.zeros(B), prev_observation=torch.tensor(prev_obs),
        t=torch.tensor(6, dtype=torch.int32))
    with torch.no_grad():
        got = forecast.forecast_online(state, transition, emission, H,
                                       noise)
    assert noise.exhausted() and seen == [6, 7, 8, 9]
    np.testing.assert_allclose(got["latents"].numpy(),
                               np.asarray(want["latents"]), atol=1e-5)
    np.testing.assert_allclose(got["observations"].numpy(),
                               np.asarray(want["observations"]), atol=1e-5)
    assert isinstance(inference.DeviceTimeIndex(state.t) + 1, torch.Tensor)
