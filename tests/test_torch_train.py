"""The port's training loop against the JAX package.

Adam steps of the port (`torch.optim.Adam`) are held against the JAX
package's train step (`optax.adam`) on the same LGSSM, observations and
replayed noise: the parameters agree within 1e-5 after each step (the two
optimizers compute the same update in float32 in different orders). The
rest checks the loop's contract: the callback's (epoch, iteration) pairs,
the synthetic dataloader, parameter discovery, the conjugate-Gaussian
model's `from_numpy`, and a short parameter recovery on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from aesmc_tpu import inference as jax_inference
from aesmc_tpu import losses as jax_losses
from aesmc_tpu import train as jax_train
from aesmc_tpu.models import gaussian as jax_gaussian
from aesmc_tpu.models import lgssm as jax_lgssm
from aesmc_tpu_torch import losses, train
from aesmc_tpu_torch.models import gaussian, lgssm
from aesmc_tpu_torch.noise import NoiseSource
from torch_replay import (ReplayNoise, fields, lgssm_params, replayed_noise,
                          simulate, tensor)

CPU = "cpu"
LEAVES = (("transition", "mult"), ("emission", "mult"),
          ("proposal", "lin_0_weight"), ("proposal", "lin_0_bias"),
          ("proposal", "lin_t_weight"), ("proposal", "lin_t_bias"))


def _params_close(jax_comps, comps, atol):
    named_jax = dict(zip(("initial", "transition", "emission", "proposal"),
                         jax_comps))
    named = dict(zip(("initial", "transition", "emission", "proposal"),
                     comps))
    for component, name in LEAVES:
        np.testing.assert_allclose(
            getattr(named[component], name).detach().numpy(),
            np.asarray(getattr(named_jax[component], name)), rtol=0,
            atol=atol, err_msg=f"{component}.{name}")


@pytest.mark.parametrize("algorithm", ["iwae", "aesmc"])
def test_adam_steps_match_optax(algorithm):
    num_timesteps, batch, k, lr = 8, 3, 32, 1e-2
    jax_comps = (jax_lgssm.Initial(0.0, 1.0),
                 jax_lgssm.Transition.create(0.5, 1.0),
                 jax_lgssm.Emission.create(0.8, 0.5),
                 jax_lgssm.Proposal.create(1.0, 0.8, jax.random.PRNGKey(2)))
    comps = lgssm.from_numpy(lgssm_params(jax_comps), device=CPU)
    obs = simulate(7, num_timesteps, batch)
    optimizer = optax.adam(lr)
    jax_step = jax_train.make_train_step(k, algorithm, optimizer,
                                         with_metrics=True, jit=False)
    opt_state = optimizer.init(jax_comps)
    step = train.make_train_step(
        k, algorithm,
        torch.optim.Adam(train.get_chained_params(*comps), lr=lr),
        with_metrics=True)
    is_smc = algorithm == "aesmc"
    for i in range(3):
        key = jax.random.PRNGKey(10 + i)
        # The draws the JAX step makes, at its current parameters.
        out = jax_inference.infer(
            "smc" if is_smc else "is", jnp.asarray(obs), *jax_comps, k,
            key=key, return_original_latents=is_smc,
            return_ancestral_indices=is_smc)
        noise = replayed_noise(
            jax_comps[3], obs, key,
            out["original_latents"] if is_smc else out["latents"],
            out["ancestral_indices"] if is_smc else None)
        jax_comps, opt_state, jax_loss, jax_metrics = jax_step(
            jax_comps, opt_state, jnp.asarray(obs), key)
        loss, metrics = step(comps, tensor(obs), noise)
        assert noise.exhausted() and not loss.requires_grad
        np.testing.assert_allclose(float(loss), float(jax_loss), rtol=0,
                                   atol=1e-3)
        np.testing.assert_allclose(float(metrics["grad_norm"]),
                                   float(jax_metrics["grad_norm"]),
                                   rtol=1e-3)
        _params_close(jax_comps, comps, atol=1e-5)


def test_callback_contract():
    loader = train.get_synthetic_dataloader(
        gaussian.Prior.create(0.0, 1.0), None, gaussian.Likelihood.create(1.0),
        1, 4, NoiseSource.seeded(0, device=CPU))
    calls = []

    def callback(epoch_idx, it_idx, loss, initial, transition, emission,
                 proposal):
        calls.append((epoch_idx, it_idx, float(loss)))
        assert isinstance(initial, gaussian.Prior)
        assert transition is None
        assert isinstance(loss, torch.Tensor) and not loss.requires_grad

    prior = gaussian.Prior.create(1.0, 1.0)
    out = train.train(loader, 2, "iwae", prior, None,
                      gaussian.Likelihood.create(1.0),
                      gaussian.InferenceNetwork.create(1.0, 0.0, 1.0),
                      num_epochs=2, num_iterations_per_epoch=3,
                      callback=callback,
                      noise=NoiseSource.seeded(1, device=CPU))
    assert [c[:2] for c in calls] == [
        (0, 0), (0, 1), (0, 2), (1, 0), (1, 1), (1, 2)]
    assert out[0] is prior and float(prior.mean.detach()) != 1.0


def test_synthetic_dataloader_shapes_and_freshness():
    transition = lgssm.Transition(0.9, 1.0)
    loader = train.get_synthetic_dataloader(
        lgssm.Initial(0.0, 1.0), transition, lgssm.Emission(1.0, 0.1), 6, 4,
        NoiseSource.seeded(0, device=CPU))
    it = iter(loader)
    a, b = next(it), next(it)
    assert a.shape == (6, 4) and a.device.type == CPU
    assert not torch.allclose(a, b)
    assert not a.requires_grad and transition.mult.requires_grad
    # The loader leaves grad mode on for the training step between draws.
    assert torch.is_grad_enabled()


def test_get_chained_params():
    transition = lgssm.Transition(0.9, 1.0)
    proposal = lgssm.Proposal.create(1.0, 1.0,
                                     torch.Generator().manual_seed(0))
    params = train.get_chained_params(transition, None, proposal, transition)
    assert len(params) == 5  # mult + 4 proposal tensors, each once
    assert train.get_chained_params(None, lgssm.Initial(0.0, 1.0)) is None
    with pytest.raises(ValueError, match="no trainable"):
        train.train([], 2, "iwae", lgssm.Initial(0.0, 1.0), None, None,
                    None, num_epochs=1)


def test_gaussian_from_numpy_round_trip_and_loss_match_jax():
    jax_comps = (jax_gaussian.Prior.create(0.3, 1.0),
                 jax_gaussian.Likelihood.create(0.7),
                 jax_gaussian.InferenceNetwork.create(0.5, 0.1, 0.8))
    params = dict(zip(("prior", "likelihood", "inference_network"),
                      (fields(c) for c in jax_comps)))
    comps = gaussian.from_numpy(params, device=CPU)
    for (name, field), module in zip(params.items(), comps):
        for key, value in field.items():
            got = getattr(module, key)
            got = got.detach().numpy() if isinstance(got, torch.Tensor) \
                else np.asarray(got, np.float32)
            np.testing.assert_array_equal(got, value, err_msg=name)
    assert train.get_chained_params(*comps) is not None
    assert len(train.get_chained_params(*comps)) == 5

    obs = np.random.RandomState(1).randn(1, 8).astype(np.float32)
    key = jax.random.PRNGKey(3)
    prior, lik, q = jax_comps
    want = jax_losses.get_loss(jnp.asarray(obs), 16, "iwae", prior, None,
                               lik, q, key=key)
    latents = np.asarray(jax_inference.infer(
        "is", jnp.asarray(obs), prior, None, lik, q, 16, key=key)["latents"])
    loc = float(q.mult) * obs[0] + float(q.bias)
    eps = (latents[0] - loc[:, None]) / float(jnp.exp(q.log_std))
    got = losses.get_loss(tensor(obs), 16, "iwae", comps[0], None, comps[1],
                          comps[2], noise=ReplayNoise(normals=[eps]))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=0,
                               atol=1e-4)
    q_mult, q_bias, q_std = gaussian.get_proposal_params(0.3, 1.0, 0.7)
    np.testing.assert_allclose(
        (q_mult, q_bias, q_std),
        jax_gaussian.get_proposal_params(0.3, 1.0, 0.7))


def test_lgssm_parameter_recovery_on_cpu():
    """The JAX package's recovery test (T=20, B=16, K=50, 150 Adam steps
    at lr 5e-2 from a0 = c0 = 0, from its initial proposal) on the port:
    the learned transition and emission multipliers halve their distance
    to the truth. (The model is symmetric under x -> -x, c -> -c: an
    initial proposal of the other orientation converges to c = -1.)"""
    true_a, true_c, a0, c0 = 0.9, 1.0, 0.0, 0.0
    scale_0, scale_t = lgssm.optimal_proposal_scales(1.0, 1.0, true_c, 0.1)
    jax_proposal = jax_lgssm.Proposal.create(scale_0, scale_t,
                                             jax.random.PRNGKey(0))
    proposal = lgssm.from_numpy(lgssm_params(
        (jax_lgssm.Initial(0.0, 1.0), jax_lgssm.Transition.create(a0, 1.0),
         jax_lgssm.Emission.create(c0, 0.1), jax_proposal)), device=CPU)[3]
    loader = train.get_synthetic_dataloader(
        lgssm.Initial(0.0, 1.0), lgssm.Transition(true_a, 1.0),
        lgssm.Emission(true_c, 0.1), 20, 16,
        NoiseSource.seeded(0, device=CPU))
    components = train.train(
        loader, 50, "aesmc", lgssm.Initial(0.0, 1.0),
        lgssm.Transition(a0, 1.0), lgssm.Emission(c0, 0.1),
        proposal, num_epochs=1, num_iterations_per_epoch=150,
        optimizer_kwargs={"lr": 5e-2},
        noise=NoiseSource.seeded(3, device=CPU))
    _, transition, emission, _ = components
    err0 = np.linalg.norm([a0 - true_a, c0 - true_c])
    err = np.linalg.norm([transition.mult.item() - true_a,
                          emission.mult.item() - true_c])
    assert err < 0.5 * err0, (err, err0)


def test_gaussian_iwae_training_converges():
    """The JAX package's conjugate-Gaussian convergence test on the port,
    with `TrainingStats` as the callback: every learned parameter ends
    within 0.25 of its optimum and the loss falls."""
    true_prior_mean, prior_std, true_obs_std = 0.0, 1.0, 1.0
    loader = train.get_synthetic_dataloader(
        gaussian.Prior.create(true_prior_mean, prior_std), None,
        gaussian.Likelihood.create(true_obs_std), 1, 100,
        NoiseSource.seeded(0, device=CPU))
    stats = gaussian.TrainingStats(verbose=False)
    prior, _, lik, q = train.train(
        loader, 4, "iwae", gaussian.Prior.create(1.5, prior_std), None,
        gaussian.Likelihood.create(0.6),
        gaussian.InferenceNetwork.create(1.5, 1.5, 1.5),
        num_epochs=1, num_iterations_per_epoch=500,
        optimizer_kwargs={"lr": 2e-2}, callback=stats,
        noise=NoiseSource.seeded(7, device=CPU))
    q_mult, q_bias, q_std = gaussian.get_proposal_params(
        true_prior_mean, prior_std, true_obs_std)
    assert len(stats.loss_history) == 500
    assert abs(stats.prior_mean_history[-1] - true_prior_mean) < 0.25
    assert abs(stats.obs_std_history[-1] - true_obs_std) < 0.25
    assert abs(stats.q_mult_history[-1] - q_mult) < 0.25
    assert abs(stats.q_bias_history[-1] - q_bias) < 0.25
    assert abs(stats.q_std_history[-1] - q_std) < 0.25
    assert stats.prior_mean_history[-1] == prior.mean.item()
    assert np.mean(stats.loss_history[-20:]) < np.mean(
        stats.loss_history[:20])
