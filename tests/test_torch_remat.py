"""Rematerialization (`remat=True`) in the port.

Ports `tests/test_inference.py::TestRemat`: with remat the log-Z equals
the plain run's and the transition gradient agrees within 1e-4 relative.
The port's recompute must not draw new noise: remat draws exactly as
many noise values as the plain step, and on the JAX package's replayed
noise the port's remat loss and gradient agree with the JAX package's
remat run. The HMM's int32 latents and ESS-adaptive resampling go through
the checkpointed step as well.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aesmc_tpu import inference as jax_inference
from aesmc_tpu import statistics as jax_statistics
from aesmc_tpu.models import lgssm as jax_lgssm
from aesmc_tpu_torch import inference, losses, statistics
from aesmc_tpu_torch.models import hmm, lgssm
from aesmc_tpu_torch.noise import NoiseSource
from torch_replay import lgssm_params, replayed_noise, tensor

KEY = jax.random.PRNGKey(0)
CPU = "cpu"
T, B, K = 12, 3, 16


def _jax_components():
    """The JAX test's model (tests/test_inference.py:414-421)."""
    return (jax_lgssm.Initial(0.0, 1.0),
            jax_lgssm.Transition.create(0.9, 1.0),
            jax_lgssm.Emission.create(1.0, 0.3),
            jax_lgssm.Proposal.create(1.0, 1.0, KEY))


def _setup():
    jax_comps = _jax_components()
    _, obs = jax_statistics.sample_from_prior(*jax_comps[:3], T, B, KEY)
    return jax_comps, obs


class _Counting:
    """Counts the noise values drawn through it."""

    def __init__(self, noise):
        self.noise = noise
        self.device = noise.device
        self.drawn = 0

    def _count(self, x):
        self.drawn += x.numel()
        return x

    def normal(self, shape):
        return self._count(self.noise.normal(shape))

    def uniform(self, shape):
        return self._count(self.noise.uniform(shape))


def _loss_and_grad(comps, obs, noise, remat, **kwargs):
    for p in comps[1].parameters():
        p.grad = None
    loss = losses.get_loss(obs, K, "aesmc", *comps, noise=noise,
                           remat=remat, **kwargs)
    loss.backward()
    return loss.detach(), comps[1].mult.grad.clone()


def test_remat_matches_and_differentiates():
    _, obs = _setup()
    comps = lgssm.from_numpy(lgssm_params(_jax_components()), device=CPU)
    outs = [inference.infer("smc", tensor(obs), *comps, K,
                            noise=NoiseSource.seeded(0, CPU), remat=remat,
                            return_log_marginal_likelihood=True)
            for remat in (False, True)]
    np.testing.assert_allclose(
        outs[1]["log_marginal_likelihood"].detach().numpy(),
        outs[0]["log_marginal_likelihood"].detach().numpy(), rtol=1e-5)
    plain = _loss_and_grad(comps, tensor(obs), NoiseSource.seeded(1, CPU),
                           False)
    remat = _loss_and_grad(comps, tensor(obs), NoiseSource.seeded(1, CPU),
                           True)
    assert torch.equal(plain[0], remat[0])
    np.testing.assert_allclose(float(remat[1]), float(plain[1]), rtol=1e-4)


@pytest.mark.parametrize("method", ["systematic", "multinomial"])
def test_remat_draws_no_more_noise(method):
    """The recompute replays the forward's draws: the step, forward and
    backward, draws as many noise values with remat as without."""
    _, obs = _setup()
    comps = lgssm.from_numpy(lgssm_params(_jax_components()), device=CPU)
    counts = []
    for remat in (False, True):
        noise = _Counting(NoiseSource.seeded(2, CPU))
        if method == "multinomial":
            noise.exponential = lambda shape, n=noise: n._count(
                n.noise.exponential(shape))
        _loss_and_grad(comps, tensor(obs), noise, remat,
                       resampling_method=method)
        counts.append(noise.drawn)
    assert counts[0] == counts[1] > 0


def test_remat_replays_jax():
    """The JAX package's remat run replayed into the port's: the loss and
    the transition gradient agree."""
    jax_comps, obs = _setup()
    key = jax.random.PRNGKey(3)

    def jax_loss(transition):
        r = jax_inference.infer("smc", obs, jax_comps[0], transition,
                                *jax_comps[2:], K, key=key, remat=True,
                                return_log_marginal_likelihood=True,
                                return_latents=False)
        return -jnp.mean(r["log_marginal_likelihood"])

    want_loss, want_grad = jax.value_and_grad(jax_loss)(jax_comps[1])
    draws = jax_inference.infer(
        "smc", obs, *jax_comps, K, key=key, return_original_latents=True,
        return_ancestral_indices=True)
    noise = replayed_noise(jax_comps[3], np.asarray(obs), key,
                           draws["original_latents"],
                           draws["ancestral_indices"])
    comps = lgssm.from_numpy(lgssm_params(jax_comps), device=CPU)
    loss, grad = _loss_and_grad(comps, tensor(obs), noise, True)
    assert noise.exhausted()
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(float(grad), float(want_grad.mult),
                               rtol=1e-3)


@pytest.mark.parametrize("criterion", ["always", 0.5])
def test_remat_hmm_int_latents(criterion):
    """The HMM's int32 particles through the checkpointed step, always and
    ESS-adaptive: the loss and the emission means' gradient equal the
    plain run's."""
    comps = hmm.make_model(num_states=3, emission_scale=0.6, stay_prob=0.85,
                           proposal="bootstrap", device=CPU)
    with torch.no_grad():
        _, obs = statistics.sample_from_prior(
            *comps[:3], 8, 2, NoiseSource.seeded(7, CPU))
    results = []
    for remat in (False, True):
        comps[2].locs.grad = None
        loss = losses.get_loss(obs, 32, "aesmc", *comps,
                               noise=NoiseSource.seeded(4, CPU),
                               resampling_criterion=criterion, remat=remat)
        loss.backward()
        results.append((loss.detach(), comps[2].locs.grad.clone()))
    assert torch.equal(results[0][0], results[1][0])
    np.testing.assert_allclose(results[1][1].numpy(), results[0][1].numpy(),
                               rtol=1e-5, atol=1e-7)
