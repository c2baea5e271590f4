"""The port's SMC/IS filtering slice against the JAX package.

The same LGSSM goes through both packages (`lgssm.from_numpy` builds the
port's modules from the JAX components' fields) on observations made from
a numpy seed. The JAX run uses its Pallas resampling kernel through the
interpreter; its noise is then replayed into the port: the proposal's
standard-normal draws are recovered as eps = (x - loc) / scale from its
latents, and the resampling uniforms are redrawn from its key schedule
(`split(key, (T, 2))[t, 0]`, as the engine draws them).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aesmc_tpu import inference as jax_inference
from aesmc_tpu import statistics as jax_statistics
from aesmc_tpu.models import lgssm as jax_lgssm
from aesmc_tpu.ops import resample_pallas
from aesmc_tpu_torch import inference, resampling, statistics
from aesmc_tpu_torch.models import kalman, lgssm
from aesmc_tpu_torch.noise import NoiseSource
from aesmc_tpu_torch.ops import resample_cuda
from torch_replay import lgssm_params, replayed_noise
from torch_replay import simulate as _simulate
from torch_replay import tensor as _t

T, B, K = 10, 3, 600


@pytest.fixture(scope="module")
def models():
    jax_comps = (jax_lgssm.Initial(0.0, 1.0),
                 jax_lgssm.Transition.create(0.9, 1.0),
                 jax_lgssm.Emission.create(1.0, 0.5),
                 jax_lgssm.Proposal.create(1.0, 0.8, jax.random.PRNGKey(1)))
    return jax_comps, lgssm.from_numpy(lgssm_params(jax_comps),
                                       device="cpu")


def _replayed_noise(jax_comps, obs, key, latents, ancestors):
    """The JAX run's draws: eps per step, and uniforms for smc."""
    return replayed_noise(jax_comps[3], obs, key, latents, ancestors)


def test_smc_slice_matches_jax(models, monkeypatch):
    jax_comps, torch_comps = models
    obs = _simulate(0, T, B)
    key = jax.random.PRNGKey(2)
    monkeypatch.setattr(resample_pallas, "FORCE_INTERPRET", True)
    want = jax_inference.infer(
        "smc", jnp.asarray(obs), *jax_comps, K, key=key,
        resampling_implementation="pallas",
        return_log_marginal_likelihood=True, return_original_latents=True,
        return_ancestral_indices=True)
    noise = _replayed_noise(jax_comps, obs, key, want["original_latents"],
                            want["ancestral_indices"])
    with torch.no_grad():
        got = inference.infer(
            "smc", _t(obs), *torch_comps, K, noise=noise,
            return_log_marginal_likelihood=True,
            return_original_latents=True, return_ancestral_indices=True)
    assert not noise.uniforms and not noise.normals
    np.testing.assert_allclose(got["log_marginal_likelihood"].numpy(),
                               np.asarray(want["log_marginal_likelihood"]),
                               rtol=0, atol=1e-3)
    # The recovered eps is within an ulp of the JAX draw, and torch sums the
    # CDF in another order than XLA: a position within ulps of a bin edge
    # may pick the neighbouring ancestor. Such flips are rare, not absent.
    same = (got["ancestral_indices"].numpy() ==
            np.asarray(want["ancestral_indices"]))
    assert same.mean() >= 0.999, same.mean()
    assert got["latents"].shape == (T, B, K)
    assert got["log_weight"].shape == (B, K)
    np.testing.assert_allclose(got["original_latents"].numpy(),
                               np.asarray(want["original_latents"]),
                               rtol=0, atol=1e-4)


def test_is_slice_matches_jax(models):
    jax_comps, torch_comps = models
    obs = _simulate(1, T, B)
    key = jax.random.PRNGKey(4)
    want = jax_inference.infer(
        "is", jnp.asarray(obs), *jax_comps, K, key=key,
        return_log_marginal_likelihood=True, return_log_weights=True)
    noise = _replayed_noise(jax_comps, obs, key, want["latents"], None)
    with torch.no_grad():
        got = inference.infer("is", _t(obs), *torch_comps, K, noise=noise,
                              return_log_marginal_likelihood=True,
                              return_log_weights=True)
    np.testing.assert_allclose(got["log_marginal_likelihood"].numpy(),
                               np.asarray(want["log_marginal_likelihood"]),
                               rtol=0, atol=1e-3)
    np.testing.assert_allclose(got["log_weights"].numpy(),
                               np.asarray(want["log_weights"]),
                               rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(got["latents"].numpy(),
                               np.asarray(want["latents"]), rtol=0, atol=1e-4)
    assert got["ancestral_indices"] is None


def test_get_resampled_latents_matches_jax():
    rng = np.random.RandomState(3)
    latents = rng.randn(6, 2, 9).astype(np.float32)
    anc = np.sort(rng.randint(0, 9, size=(5, 2, 9)), axis=2).astype(np.int32)
    want = np.asarray(jax_inference.get_resampled_latents(
        jnp.asarray(latents), jnp.asarray(anc)))
    got = inference.get_resampled_latents(_t(latents), _t(anc)).numpy()
    np.testing.assert_array_equal(got, want)
    single = inference.get_resampled_latents(_t(latents[:1]), [])
    np.testing.assert_array_equal(single.numpy(), latents[:1])


def test_return_vocabulary_and_empty_ancestors(models, monkeypatch):
    _, torch_comps = models
    obs = _t(_simulate(2, 4, 2))
    # The time loop never waits for the device: no NaN check in it.
    def no_sync(_):
        raise AssertionError("infer's time loop read a value back")
    monkeypatch.setattr(resampling, "_check_nan_eager", no_sync)
    seen = []
    real = resample_cuda.resample_and_gather_systematic_torch
    # Above the dense route's K, the 'torch' route runs K1's plain version.
    k = resampling.DENSE_GATHER_MAX_K + 1

    def spy(cdf, u, value, emit_idx=True):
        seen.append(emit_idx)
        return real(cdf, u, value, emit_idx)

    monkeypatch.setattr(resample_cuda,
                        "resample_and_gather_systematic_torch", spy)
    with torch.no_grad():
        out = inference.infer("smc", obs, *torch_comps, k,
                              return_log_marginal_likelihood=True,
                              return_latents=False)
    assert seen == [False] * 3
    assert out["latents"] is None and out["ancestral_indices"] is None
    assert out["log_marginal_likelihood"].shape == (2,)
    with torch.no_grad():
        out = inference.infer("smc", [o for o in obs], *torch_comps, k,
                              return_ancestral_indices=True,
                              return_log_weights=True)
    assert seen[3:] == [True] * 3
    assert out["ancestral_indices"].shape == (3, 2, k)
    assert out["ancestral_indices"].dtype == torch.int32
    assert out["log_weights"].shape == (4, 2, k)
    assert out["last_latent"].shape == (2, k)
    with pytest.raises(ValueError):
        inference.infer("bogus", obs, *torch_comps, k)
    with pytest.raises(ValueError):
        inference.infer("is", obs, *torch_comps, k,
                        return_ancestral_indices=True)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        inference.infer("smc", obs, *torch_comps, k,
                        resampling_implementation="cuda")


def test_time_index_and_observation_sequence():
    seq = inference.ObservationSequence(torch.arange(12.0).reshape(3, 4))
    assert len(seq) == 3
    assert torch.equal(seq[inference.TimeIndex(1)], torch.arange(4.0) + 4)
    assert len(seq[:2]) == 2
    assert inference.TimeIndex(2) != 0
    stacked = inference.stack_observations([np.ones(2), np.zeros(2)],
                                           device="cpu")
    assert stacked.shape == (2, 2)


def test_statistics_match_jax():
    rng = np.random.RandomState(6)
    value = rng.randn(3, 50).astype(np.float32)
    logw = rng.randn(3, 50).astype(np.float32) * 2
    for name in ("empirical_mean", "empirical_variance"):
        want = np.asarray(getattr(jax_statistics, name)(
            jnp.asarray(value), jnp.asarray(logw)))
        got = getattr(statistics, name)(_t(value), _t(logw)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    for name in ("ess", "log_ess"):
        want = np.asarray(getattr(jax_statistics, name)(jnp.asarray(logw)))
        got = getattr(statistics, name)(_t(logw)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_full_shape_log_z_matches_kalman():
    """The bench's shape (T=200, B=10, K=10,000) on the CPU, with the
    optimal proposal: log-Z within the repo's 5% Kalman-oracle bound."""
    num_timesteps, batch, particles = 200, 10, 10000
    initial = lgssm.Initial(0.0, 1.0)
    transition = lgssm.Transition(0.9, 1.0)
    emission = lgssm.Emission(1.0, 0.2)
    proposal = lgssm.optimal_proposal(0.0, 1.0, 0.9, 1.0, 1.0, 0.2)
    with torch.no_grad():
        _, obs = statistics.sample_from_prior(
            initial, transition, emission, num_timesteps, batch,
            NoiseSource.seeded(1, device="cpu"))
        out = inference.infer("smc", obs, initial, transition, emission,
                              proposal, particles,
                              noise=NoiseSource.seeded(2, device="cpu"),
                              return_log_marginal_likelihood=True,
                              return_latents=False)
    log_z = out["log_marginal_likelihood"].numpy()
    params = kalman.KalmanParams(0.0, 1.0, 0.9, 0.0, 1.0, 1.0, 0.0, 0.04)
    exact = np.array([kalman.kalman_filter(obs[:, b].numpy(), params)[4]
                      for b in range(batch)])
    assert obs.shape == (num_timesteps, batch)
    assert np.all(np.abs(log_z - exact) / np.abs(exact) < 0.05)
