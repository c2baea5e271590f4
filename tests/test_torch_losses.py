"""The port's ELBO objectives against the JAX package.

The same LGSSM (`lgssm.from_numpy` of the JAX components) and the same
observations go through `losses.get_loss` in both packages; the JAX run's
noise is replayed into the port (`torch_replay`). For 'aesmc' the JAX side
resamples through its Pallas kernel, interpreted, so its range-sum
backward (K2's JAX form) computes its gradients; the port runs either its
plain route or its kernel wrappers, which on CPU tensors run K1's and K2's
plain versions.

Tolerances: the loss within 1e-3 absolute and every gradient within
rtol 1e-3 / atol 1e-4: the replayed eps is within an ulp of JAX's draw and
the two libraries sum in different orders. The ancestors are first
checked to agree exactly for the chosen seed: a bin-edge flip would move
whole particles and make the comparison meaningless.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aesmc_tpu import inference as jax_inference
from aesmc_tpu import losses as jax_losses
from aesmc_tpu.models import lgssm as jax_lgssm
from aesmc_tpu.ops import resample_pallas
from aesmc_tpu_torch import inference, losses, resampling
from aesmc_tpu_torch.models import gaussian, lgssm
from aesmc_tpu_torch.noise import NoiseSource
from aesmc_tpu_torch.ops import range_sum_cuda
from torch_replay import lgssm_params, replayed_noise, simulate, tensor

T, B, K = 10, 3, 64
LEAVES = (("transition", "mult"), ("emission", "mult"),
          ("proposal", "lin_0_weight"), ("proposal", "lin_0_bias"),
          ("proposal", "lin_t_weight"), ("proposal", "lin_t_bias"))


def _jax_components():
    return (jax_lgssm.Initial(0.0, 1.0),
            jax_lgssm.Transition.create(0.6, 1.0),
            jax_lgssm.Emission.create(0.8, 0.5),
            jax_lgssm.Proposal.create(1.0, 0.8, jax.random.PRNGKey(1)))


def _jax_run(algorithm, obs, key, jax_comps, implementation):
    """(loss, grads of (transition, emission, proposal), infer output)."""
    initial = jax_comps[0]

    def loss_fn(trainable):
        return jax_losses.get_loss(
            jnp.asarray(obs), K, algorithm, initial, *trainable, key=key,
            resampling_implementation=implementation)

    loss, grads = jax.value_and_grad(loss_fn)(tuple(jax_comps[1:]))
    is_smc = algorithm == "aesmc"
    out = jax_inference.infer(
        "smc" if is_smc else "is", jnp.asarray(obs), *jax_comps, K, key=key,
        resampling_implementation=implementation,
        return_original_latents=is_smc, return_ancestral_indices=is_smc)
    return loss, grads, out


@pytest.mark.parametrize("algorithm,route", [
    ("iwae", "torch"), ("aesmc", "torch"), ("aesmc", "kernel_wrappers")])
def test_loss_and_gradients_match_jax(algorithm, route, monkeypatch):
    jax_comps = _jax_components()
    comps = lgssm.from_numpy(lgssm_params(jax_comps), device="cpu")
    obs = simulate(3, T, B, mult=0.9, em_scale=0.5)
    key = jax.random.PRNGKey(4)
    implementation = "xla"
    if algorithm == "aesmc":
        monkeypatch.setattr(resample_pallas, "FORCE_INTERPRET", True)
        implementation = "pallas"
    loss, grads, out = _jax_run(algorithm, obs, key, jax_comps,
                                implementation)
    backward_calls = []
    if route == "kernel_wrappers":
        # The 'cuda' route's wrappers on CPU tensors: K1's autograd
        # function with K2's plain version as its backward.
        monkeypatch.setattr(resampling, "resolve_implementation",
                            lambda *args: "cuda")
        plain = range_sum_cuda.range_sum_torch

        def spy(*args):
            backward_calls.append(1)
            return plain(*args)

        monkeypatch.setattr(range_sum_cuda, "range_sum_torch", spy)

    is_smc = algorithm == "aesmc"
    latents = out["original_latents"] if is_smc else out["latents"]
    ancestors = out["ancestral_indices"] if is_smc else None
    if is_smc:
        noise = replayed_noise(jax_comps[3], obs, key, latents, ancestors)
        with torch.no_grad():
            check = inference.infer("smc", tensor(obs), *comps, K,
                                    noise=noise,
                                    return_ancestral_indices=True)
        np.testing.assert_array_equal(check["ancestral_indices"].numpy(),
                                      np.asarray(ancestors))

    noise = replayed_noise(jax_comps[3], obs, key, latents, ancestors)
    got = losses.get_loss(tensor(obs), K, algorithm, *comps, noise=noise)
    got.backward()
    assert noise.exhausted() and got.shape == ()
    assert len(backward_calls) == (T - 1 if route == "kernel_wrappers" else 0)
    np.testing.assert_allclose(float(got.detach()), float(loss), rtol=0,
                               atol=1e-3)
    modules = dict(zip(("initial", "transition", "emission", "proposal"),
                       comps))
    jax_grads = dict(zip(("transition", "emission", "proposal"), grads))
    for component, name in LEAVES:
        np.testing.assert_allclose(
            getattr(modules[component], name).grad.numpy(),
            np.asarray(getattr(jax_grads[component], name)),
            rtol=1e-3, atol=1e-4, err_msg=f"{component}.{name}")


def test_loss_and_metrics_match_jax():
    jax_comps = _jax_components()
    comps = lgssm.from_numpy(lgssm_params(jax_comps), device="cpu")
    obs = simulate(5, T, B)
    key = jax.random.PRNGKey(6)
    loss, metrics = jax_losses.get_loss_and_metrics(
        jnp.asarray(obs), K, "aesmc", *jax_comps, key=key)
    out = jax_inference.infer("smc", jnp.asarray(obs), *jax_comps, K,
                              key=key, return_original_latents=True,
                              return_ancestral_indices=True)
    noise = replayed_noise(jax_comps[3], obs, key, out["original_latents"],
                           out["ancestral_indices"])
    got, got_metrics = losses.get_loss_and_metrics(
        tensor(obs), K, "aesmc", *comps, noise=noise)
    assert set(got_metrics) == {"elbo", "ess"}
    np.testing.assert_allclose(float(got.detach()), float(loss), rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(float(got_metrics["elbo"]),
                               float(metrics["elbo"]), rtol=0, atol=1e-3)
    np.testing.assert_allclose(float(got_metrics["ess"]),
                               float(metrics["ess"]), rtol=1e-3)
    assert float(got.detach()) == -float(got_metrics["elbo"])
    assert not got_metrics["elbo"].requires_grad


def test_single_timestep_iwae_equals_aesmc():
    """For T = 1 (no transition) the IS and SMC estimators coincide
    exactly on the same noise."""
    prior = gaussian.Prior.create(0.0, 1.0)
    lik = gaussian.Likelihood.create(1.0)
    q = gaussian.InferenceNetwork.create(0.5, 0.0, 0.8)
    obs = torch.tensor(np.random.RandomState(0).randn(1, 6),
                       dtype=torch.float32)
    iwae = losses.get_loss(obs, 4, "iwae", prior, None, lik, q,
                           noise=NoiseSource.seeded(3, device="cpu"))
    aesmc = losses.get_loss(obs, 4, "aesmc", prior, None, lik, q,
                            noise=NoiseSource.seeded(3, device="cpu"))
    assert float(iwae.detach()) == float(aesmc.detach())


def test_bad_and_later_options_raise():
    comps = lgssm.from_numpy(lgssm_params(_jax_components()), device="cpu")
    obs = tensor(simulate(0, 3, 2))
    noise = NoiseSource.seeded(0, device="cpu")
    with pytest.raises(ValueError, match="algorithm"):
        losses.get_loss(obs, 8, "bogus", *comps, noise=noise)
    with pytest.raises(ValueError, match="algorithm"):
        losses.get_loss_and_metrics(obs, 8, "bogus", *comps, noise=noise)
    with pytest.raises(ValueError, match="gradient_estimator"):
        losses.get_loss(obs, 8, "aesmc", *comps, noise=noise,
                        gradient_estimator="bogus")
    # 'tmc' and the score-function estimator are ported (tests/
    # test_torch_tmc.py, tests/test_torch_gradients.py): both run.
    assert torch.isfinite(losses.get_loss(obs, 8, "tmc", *comps,
                                          noise=noise))
    assert torch.isfinite(losses.get_loss(
        obs, 8, "aesmc", *comps, noise=noise,
        resampling_method="multinomial", gradient_estimator="score"))
    # The NaN guard is ported (tests/test_torch_nan_check.py): on clean
    # data it passes.
    assert torch.isfinite(losses.get_loss(obs, 8, "aesmc", *comps,
                                          noise=noise, nan_check=True))
    error, loss = losses.checked_loss(obs, 8, "aesmc", *comps, noise=noise)
    assert error.get() is None and torch.isfinite(loss)
