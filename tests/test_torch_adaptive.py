"""ESS-adaptive resampling in the port, against the JAX package.

Ports `tests/test_inference.py::TestAdaptiveResampling` and
`test_adaptive_mixed_rows_select_correctly` to the port, and replays the
JAX package's adaptive `infer` into the port's: the LGSSM (eps recovered
from the JAX run's latents) and a small HMM (Gumbel noise redrawn from
its keys), with the JAX package's CDF patched in so that the ancestors
compare exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aesmc_tpu import inference as jax_inference
from aesmc_tpu import resampling as jax_resampling
from aesmc_tpu import statistics as jax_statistics
from aesmc_tpu.models import hmm as jax_hmm
from aesmc_tpu.models import lgssm as jax_lgssm
from aesmc_tpu_torch import inference, losses, resampling
from aesmc_tpu_torch.models import hmm, kalman, lgssm
from aesmc_tpu_torch.noise import NoiseSource
from torch_replay import (ReplayNoise, categorical_gumbels, fields,
                          lgssm_params, replayed_noise, resampling_draws,
                          tensor)

KEY = jax.random.PRNGKey(0)
CPU = "cpu"


def _jax_cdf(log_weight):
    return tensor(jax_resampling._normalized_cumsum(
        jnp.asarray(log_weight.detach().numpy())))


def _jax_components():
    """The JAX test's model (tests/test_inference.py:343-353)."""
    return (jax_lgssm.Initial(0.0, 1.0),
            jax_lgssm.Transition.create(0.9, 1.0),
            jax_lgssm.Emission.create(1.0, 0.3),
            jax_lgssm.Proposal.create(1.0, 1.0, KEY))


def _components(num_timesteps=15, batch=4):
    jax_comps = _jax_components()
    _, obs = jax_statistics.sample_from_prior(*jax_comps[:3], num_timesteps,
                                              batch, KEY)
    return tensor(obs), lgssm.from_numpy(lgssm_params(jax_comps),
                                         device=CPU)


class _SplitNoise:
    """Proposal and resampling noise from two generators: runs that
    resample differently still propose from the same draws, as the JAX
    package's per-step keys make them."""

    device = torch.device(CPU)

    def __init__(self, seed):
        self._proposals = NoiseSource.seeded(seed, CPU)
        self._resampling = NoiseSource.seeded(seed + 1, CPU)

    def normal(self, shape):
        return self._proposals.normal(shape)

    def uniform(self, shape):
        return self._resampling.uniform(shape)


def _log_z(out):
    return out["log_marginal_likelihood"].detach().numpy()


def test_huge_threshold_equals_always():
    obs, comps = _components()
    a = inference.infer("smc", obs, *comps, 32,
                        noise=NoiseSource.seeded(0, CPU),
                        return_log_marginal_likelihood=True)
    b = inference.infer("smc", obs, *comps, 32,
                        noise=NoiseSource.seeded(0, CPU),
                        resampling_criterion=1e9,
                        return_log_marginal_likelihood=True)
    np.testing.assert_allclose(_log_z(a), _log_z(b), rtol=1e-5)
    np.testing.assert_allclose(a["latents"].detach().numpy(),
                               b["latents"].detach().numpy(), atol=1e-6)


def test_zero_threshold_equals_is():
    obs, comps = _components()
    a = inference.infer("is", obs, *comps, 32, noise=_SplitNoise(0),
                        return_log_marginal_likelihood=True)
    b = inference.infer("smc", obs, *comps, 32, noise=_SplitNoise(0),
                        resampling_criterion=0.0,
                        return_log_marginal_likelihood=True)
    np.testing.assert_allclose(_log_z(a), _log_z(b), rtol=1e-4)


def test_adaptive_estimator_consistent():
    """K = 2,048: the adaptive log-Z lies within 5% of the Kalman filter's
    in every row."""
    obs, comps = _components()
    obs_np = obs.numpy()
    params = kalman.KalmanParams(0.0, 1.0, 0.9, 0.0, 1.0, 1.0, 0.0,
                                 0.3 ** 2)
    exact = np.array([kalman.kalman_filter(obs_np[:, b], params)[4]
                      for b in range(obs_np.shape[1])])
    with torch.no_grad():
        est = inference.infer("smc", obs, *comps, 2048,
                              noise=NoiseSource.seeded(0, CPU),
                              resampling_criterion=0.5,
                              return_log_marginal_likelihood=True,
                              return_latents=False)
    np.testing.assert_allclose(_log_z(est), exact, rtol=0.05)


def test_adaptive_training_works():
    obs, comps = _components()
    loss = losses.get_loss(obs, 16, "aesmc", *comps,
                           noise=NoiseSource.seeded(0, CPU),
                           resampling_criterion=0.5)
    loss.backward()
    grad = comps[1].mult.grad
    assert torch.isfinite(grad) and float(grad.abs()) > 0


def test_adaptive_mixed_rows_select_correctly():
    """Row 1's outlying observations concentrate its weights (low ESS:
    it resamples), row 0 keeps a high ESS (identity ancestors)."""
    num_timesteps, batch, k = 3, 2, 64
    obs, comps = _components(num_timesteps, batch)
    obs[:, 1] = 25.0
    out = inference.infer("smc", obs, *comps, k,
                          noise=NoiseSource.seeded(0, CPU),
                          resampling_criterion=0.2,
                          return_ancestral_indices=True,
                          return_log_weights=True,
                          return_log_marginal_likelihood=True)
    anc = out["ancestral_indices"].numpy()
    lw = out["log_weights"].detach()
    ess = torch.exp(2 * torch.logsumexp(lw, 2) -
                    torch.logsumexp(2 * lw, 2)).numpy()
    identity = np.arange(k)
    resampled = 0
    for t in range(num_timesteps - 1):
        for b in range(batch):
            if ess[t, b] >= 0.2 * k:
                np.testing.assert_array_equal(anc[t, b], identity)
            else:
                assert not np.array_equal(anc[t, b], identity)
                resampled += 1
    assert 0 < resampled < (num_timesteps - 1) * batch, (resampled, ess)


def _mixed(anc, k):
    """Whether the [T-1, B, K] ancestors hold both identity rows (kept)
    and resampled rows."""
    kept = (anc == np.arange(k)).all(axis=-1)
    return kept.any() and not kept.all()


@pytest.mark.parametrize("method", ["systematic", "stratified"])
def test_lgssm_replay_matches_jax(method, monkeypatch):
    """The JAX package's adaptive `infer` replayed into the port: the same
    ancestors (identity where a row kept its particles), log-Z within
    1e-5 relative."""
    jax_comps = _jax_components()
    num_timesteps, batch, k, frac = 10, 3, 64, 0.2
    _, obs = jax_statistics.sample_from_prior(*jax_comps[:3], num_timesteps,
                                              batch, KEY)
    key = jax.random.PRNGKey(5)
    want = jax_inference.infer(
        "smc", obs, *jax_comps, k, key=key, resampling_method=method,
        resampling_criterion=frac, return_log_marginal_likelihood=True,
        return_original_latents=True, return_ancestral_indices=True)
    want_anc = np.asarray(want["ancestral_indices"])
    assert _mixed(want_anc, k)
    monkeypatch.setattr(resampling, "_normalized_cumsum", _jax_cdf)
    noise = replayed_noise(jax_comps[3], np.asarray(obs), key,
                           want["original_latents"], want_anc, method)
    with torch.no_grad():
        got = inference.infer(
            "smc", tensor(obs),
            *lgssm.from_numpy(lgssm_params(jax_comps), device=CPU), k,
            noise=noise, resampling_method=method,
            resampling_criterion=frac, return_log_marginal_likelihood=True,
            return_original_latents=True, return_ancestral_indices=True)
    assert noise.exhausted()
    np.testing.assert_array_equal(got["ancestral_indices"].numpy(),
                                  want_anc)
    np.testing.assert_allclose(_log_z(got),
                               np.asarray(want["log_marginal_likelihood"]),
                               rtol=1e-5)


def test_hmm_replay_matches_jax(monkeypatch):
    """A small HMM (D = 3, T = 8, K = 64, the bootstrap proposal, whose
    weights degenerate more than the fully adapted one's): int32 latents
    kept or taken per row; ancestors and latents equal, log-Z within 1e-5
    relative."""
    d, num_timesteps, batch, k, frac = 3, 8, 2, 64, 0.5
    comps = jax_hmm.make_model(num_states=d, emission_scale=0.6,
                               stay_prob=0.85, proposal="bootstrap")
    _, obs = jax_statistics.sample_from_prior(
        *comps[:3], num_timesteps, batch, key=jax.random.PRNGKey(7))
    key = jax.random.PRNGKey(11)
    want = jax_inference.infer(
        "smc", obs, *comps, k, key=key, resampling_criterion=frac,
        return_log_marginal_likelihood=True, return_ancestral_indices=True)
    want_anc = np.asarray(want["ancestral_indices"])
    assert _mixed(want_anc, k)
    monkeypatch.setattr(resampling, "_normalized_cumsum", _jax_cdf)
    noise = ReplayNoise(
        gumbels=categorical_gumbels(key, num_timesteps, batch, k, d,
                                    first="not_expanded"),
        **resampling_draws(key, num_timesteps, batch, k, "systematic"))
    params = dict(zip(("initial", "transition", "emission", "proposal"),
                      (fields(c) for c in comps)))
    with torch.no_grad():
        got = inference.infer(
            "smc", tensor(obs), *hmm.from_numpy(params, device=CPU), k,
            noise=noise, resampling_criterion=frac,
            return_log_marginal_likelihood=True,
            return_ancestral_indices=True)
    assert noise.exhausted()
    np.testing.assert_array_equal(got["ancestral_indices"].numpy(),
                                  want_anc)
    assert got["latents"].dtype == torch.int32
    np.testing.assert_array_equal(got["latents"].numpy(),
                                  np.asarray(want["latents"]))
    np.testing.assert_allclose(_log_z(got),
                               np.asarray(want["log_marginal_likelihood"]),
                               rtol=1e-5)
