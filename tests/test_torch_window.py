"""History windows (`history_window > 1`) in the port, against the JAX
package.

A second-order model reads the window: its transition mixes the last two
latents and the oldest observation of the window, its emission the oldest
latent it is shown. Both packages run it at W = 3 with the LGSSM's affine
proposal (`lgssm.from_numpy`), the JAX run's draws replayed into the port
(eps recovered from its latents, the resampling noise redrawn from its
keys) and the JAX package's CDF patched in, so that the ancestors compare
exactly; `sample_from_prior(history_window=3)` replays the JAX draws
redrawn from its keys.

Tolerances: ancestors exactly equal; log-Z, weights and latents within
1e-4 absolute (the replayed eps is within an ulp of JAX's draw); prior
samples within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aesmc_tpu import distributions as jax_dists
from aesmc_tpu import inference as jax_inference
from aesmc_tpu import resampling as jax_resampling
from aesmc_tpu import statistics as jax_statistics
from aesmc_tpu.models import lgssm as jax_lgssm
from aesmc_tpu.state import BatchShapeMode as JaxMode
from aesmc_tpu_torch import distributions, inference, losses, resampling
from aesmc_tpu_torch import statistics
from aesmc_tpu_torch.models import lgssm
from aesmc_tpu_torch.noise import NoiseSource
from aesmc_tpu_torch.state import BatchShapeMode
from torch_replay import (ReplayNoise, lgssm_params, replayed_noise,
                          simulate, tensor)

T, B, K, W = 6, 2, 40, 3
CPU = "cpu"


class _Transition:
    """x_t ~ N(0.6 x_{t-1} + 0.3 x_{t-2} + 0.1 y_{t-W}, 1)."""

    def __init__(self, dists, mode):
        self.dists, self.mode = dists, mode

    def __call__(self, previous_latents=None, time=None,
                 previous_observations=None):
        oldest = previous_observations[0]         # [B] in infer, [B, 1]
        loc = (0.6 * previous_latents[-1] + 0.3 * previous_latents[-2] +
               0.1 * oldest.reshape(oldest.shape[0], 1))
        return self.dists.Normal(loc, 1.0, batch_shape_mode=self.mode)


class _Emission:
    """y_t ~ N(x_t + 0.2 x_oldest, 0.5^2), x_oldest the first latent of the
    window it is shown."""

    def __init__(self, dists, mode):
        self.dists, self.mode = dists, mode

    def __call__(self, latents=None, time=None, previous_observations=None):
        return self.dists.Normal(latents[-1] + 0.2 * latents[0], 0.5,
                                 batch_shape_mode=self.mode)


def _models():
    jax_lgssm_comps = (jax_lgssm.Initial(0.0, 1.0),
                       jax_lgssm.Transition.create(0.9, 1.0),
                       jax_lgssm.Emission.create(1.0, 0.5),
                       jax_lgssm.Proposal.create(1.0, 0.8,
                                                 jax.random.PRNGKey(1)))
    initial, _, _, proposal = lgssm.from_numpy(lgssm_params(jax_lgssm_comps),
                                               device=CPU)
    jax_comps = (jax_lgssm_comps[0],
                 _Transition(jax_dists, JaxMode.FULLY_EXPANDED),
                 _Emission(jax_dists, JaxMode.FULLY_EXPANDED),
                 jax_lgssm_comps[3])
    comps = (initial, _Transition(distributions,
                                  BatchShapeMode.FULLY_EXPANDED),
             _Emission(distributions, BatchShapeMode.FULLY_EXPANDED),
             proposal)
    return jax_comps, comps


@pytest.fixture
def jax_cdf(monkeypatch):
    def cdf(log_weight):
        return tensor(jax_resampling._normalized_cumsum(
            jnp.asarray(log_weight.detach().numpy())))

    monkeypatch.setattr(resampling, "_normalized_cumsum", cdf)


@pytest.mark.parametrize("algorithm,method,lookahead,criterion", [
    ("smc", "systematic", False, "always"),
    ("smc", "soft", False, "always"),
    ("smc", "multinomial", True, "always"),
    ("smc", "systematic", False, 0.5),
    ("is", "systematic", False, "always"),
])
def test_windowed_filter_matches_jax(algorithm, method, lookahead,
                                     criterion, jax_cdf):
    jax_comps, comps = _models()
    obs = simulate(21, T, B, mult=0.9, em_scale=0.5)
    key = jax.random.PRNGKey(22)
    smc = algorithm == "smc"
    jax_look = look = None
    if lookahead:
        jax_look = jax_lgssm.Lookahead.create(0.9, 1.0, 1.0, 0.5)
        look = lgssm.Lookahead(0.9, 1.0, 1.0, 0.5)
    want = jax_inference.infer(
        algorithm, jnp.asarray(obs), *jax_comps, K, key=key,
        lookahead=jax_look, resampling_method=method,
        resampling_criterion=criterion, history_window=W,
        return_log_marginal_likelihood=True, return_original_latents=smc,
        return_ancestral_indices=smc, return_log_weights=True)
    latents = want["original_latents"] if smc else want["latents"]
    ancestors = want["ancestral_indices"] if smc else None
    noise = replayed_noise(jax_comps[3], obs, key, latents, ancestors,
                           method)
    with torch.no_grad():
        got = inference.infer(
            algorithm, tensor(obs), *comps, K, noise=noise, lookahead=look,
            resampling_method=method, resampling_criterion=criterion,
            history_window=W, return_log_marginal_likelihood=True,
            return_original_latents=smc, return_ancestral_indices=smc,
            return_log_weights=True)
    assert noise.exhausted()
    names = ["log_marginal_likelihood", "log_weights", "latents"]
    if smc:
        np.testing.assert_array_equal(got["ancestral_indices"].numpy(),
                                      np.asarray(ancestors))
        names.append("original_latents")
    for name in names:
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   rtol=0, atol=1e-4, err_msg=name)


def test_sample_from_prior_window_matches_jax():
    jax_comps, comps = _models()
    key = jax.random.PRNGKey(23)
    want_x, want_y = jax_statistics.sample_from_prior(
        *jax_comps[:3], T, B, key=key, history_window=W)
    step_keys = jax.random.split(key, (T, 2))
    normals = [jax.random.normal(step_keys[t, i], (B, 1), dtype=jnp.float32)
               for t in range(T) for i in range(2)]
    noise = ReplayNoise(normals=normals)
    x, y = statistics.sample_from_prior(*comps[:3], T, B, noise,
                                        history_window=W)
    assert noise.exhausted() and x.shape == (T, B) and y.shape == (T, B)
    np.testing.assert_allclose(x.numpy(), np.asarray(want_x), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), rtol=0,
                               atol=1e-5)
    with pytest.raises(ValueError, match="history_window"):
        statistics.sample_from_prior(*comps[:3], T, B, noise,
                                     history_window=0)


def test_get_loss_passes_the_window_through():
    _, comps = _models()
    obs = tensor(simulate(24, T, B))
    loss = losses.get_loss(obs, K, "aesmc", *comps,
                           noise=NoiseSource.seeded(3, CPU),
                           history_window=W)
    out = inference.infer("smc", obs, *comps, K,
                          noise=NoiseSource.seeded(3, CPU), history_window=W,
                          return_log_marginal_likelihood=True,
                          return_latents=False)
    assert torch.equal(loss, -out["log_marginal_likelihood"].mean())
    # The window is read: W = 1 hands the transition one latent.
    with pytest.raises(IndexError):
        losses.get_loss(obs, K, "aesmc", *comps,
                        noise=NoiseSource.seeded(3, CPU))
