"""The port's score-function gradient against the JAX package's.

The same LGSSM and observations go through `score_gradient_loss` in both
packages (multinomial resampling at every step, T = 6, B = 3, K = 16).
The JAX run's draws are replayed into the port: the proposal's eps
recovered from its latents, the K + 1 exponentials of each multinomial
resampling redrawn from its keys, and the JAX package's CDF patched in,
so that the ancestors compare exactly (checked first). The port runs its
plain route, or the 'cuda' route's wrappers on CPU tensors (K3's plain
version forward, K2's backward).

Tolerances: the surrogate's value within 1e-4 absolute and every
gradient within rtol 1e-3 / atol 1e-4 (the replayed eps is within an ulp
of the JAX draw; the score term multiplies float32 sums over T steps);
the surrogate's value against the pathwise loss on the same noise within
rtol 1e-6 (the score term cancels exactly in value; the per-step log-Z
terms are summed in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aesmc_tpu import gradients as jax_gradients
from aesmc_tpu import inference as jax_inference
from aesmc_tpu import resampling as jax_resampling
from aesmc_tpu.models import lgssm as jax_lgssm
from aesmc_tpu_torch import gradients, inference, losses, resampling, train
from aesmc_tpu_torch.models import lgssm
from aesmc_tpu_torch.noise import NoiseSource
from aesmc_tpu_torch.ops import range_sum_cuda
from torch_replay import lgssm_params, replayed_noise, simulate, tensor

T, B, K = 6, 3, 16
LEAVES = (("transition", "mult"), ("emission", "mult"),
          ("proposal", "lin_0_weight"), ("proposal", "lin_0_bias"),
          ("proposal", "lin_t_weight"), ("proposal", "lin_t_bias"))


def _components():
    jax_comps = (jax_lgssm.Initial(0.0, 1.0),
                 jax_lgssm.Transition.create(0.6, 1.0),
                 jax_lgssm.Emission.create(0.8, 0.5),
                 jax_lgssm.Proposal.create(1.0, 0.8, jax.random.PRNGKey(1)))
    return jax_comps, lgssm.from_numpy(lgssm_params(jax_comps), device="cpu")


@pytest.mark.parametrize("baseline,route", [
    ("batch", "torch"), ("none", "torch"), ("batch", "kernel_wrappers")])
def test_surrogate_matches_jax(baseline, route, monkeypatch):
    jax_comps, comps = _components()
    obs = simulate(2, T, B)
    key = jax.random.PRNGKey(5)

    def loss_fn(trainable):
        return jax_gradients.score_gradient_loss(
            jnp.asarray(obs), K, jax_comps[0], *trainable, key=key,
            baseline=baseline, resampling_implementation="xla")

    loss, grads = jax.value_and_grad(loss_fn)(tuple(jax_comps[1:]))
    out = jax_inference.infer(
        "smc", jnp.asarray(obs), *jax_comps, K, key=key,
        resampling_method="multinomial", resampling_implementation="xla",
        return_original_latents=True, return_ancestral_indices=True)
    monkeypatch.setattr(resampling, "_normalized_cumsum", lambda lw: tensor(
        jax_resampling._normalized_cumsum(jnp.asarray(lw.detach().numpy()))))
    backward_calls = []
    if route == "kernel_wrappers":
        monkeypatch.setattr(resampling, "resolve_implementation",
                            lambda *args: "cuda")
        plain = range_sum_cuda.range_sum_torch

        def spy(*args):
            backward_calls.append(1)
            return plain(*args)

        monkeypatch.setattr(range_sum_cuda, "range_sum_torch", spy)

    def noise():
        return replayed_noise(jax_comps[3], obs, key,
                              out["original_latents"],
                              out["ancestral_indices"], "multinomial")

    with torch.no_grad():
        check = inference.infer("smc", tensor(obs), *comps, K,
                                noise=noise(), resampling_method="multinomial",
                                return_ancestral_indices=True)
    np.testing.assert_array_equal(check["ancestral_indices"].numpy(),
                                  np.asarray(out["ancestral_indices"]))

    replay = noise()
    got = gradients.score_gradient_loss(tensor(obs), K, *comps, noise=replay,
                                        baseline=baseline)
    got.backward()
    assert replay.exhausted()
    assert len(backward_calls) == (T - 1 if route == "kernel_wrappers"
                                   else 0)
    np.testing.assert_allclose(float(got.detach()), float(loss), atol=1e-4)
    modules = dict(zip(("initial", "transition", "emission", "proposal"),
                       comps))
    jax_grads = dict(zip(("transition", "emission", "proposal"), grads))
    for component, name in LEAVES:
        np.testing.assert_allclose(
            getattr(modules[component], name).grad.numpy(),
            np.asarray(getattr(jax_grads[component], name)),
            rtol=1e-3, atol=1e-4, err_msg=f"{component}.{name}")


def test_value_is_the_pathwise_loss_and_get_loss_routes():
    _, comps = _components()
    obs = tensor(simulate(4, T, B))
    params = train.get_chained_params(*comps)

    def seeded():
        return NoiseSource.seeded(6, device="cpu")

    pathwise = losses.get_loss(obs, K, "aesmc", *comps, noise=seeded(),
                               resampling_method="multinomial")
    score = gradients.score_gradient_loss(obs, K, *comps, noise=seeded())
    np.testing.assert_allclose(float(score.detach()),
                               float(pathwise.detach()), rtol=1e-6)
    # get_loss routes 'score' to the same surrogate.
    routed = losses.get_loss(obs, K, "aesmc", *comps, noise=seeded(),
                             resampling_method="multinomial",
                             gradient_estimator="score")
    assert torch.equal(routed, score)
    for a, b in zip(torch.autograd.grad(routed, params),
                    torch.autograd.grad(score, params)):
        assert torch.equal(a, b)
    loss, metrics = losses.get_loss_and_metrics(
        obs, K, "aesmc", *comps, noise=seeded(),
        resampling_method="multinomial", gradient_estimator="score",
        score_baseline="none")
    np.testing.assert_allclose(float(loss.detach()),
                               -float(metrics["elbo"]), rtol=1e-6)
    # Only the gradient differs from the pathwise one.
    pathwise_grads = torch.autograd.grad(pathwise, params)
    score_grads = torch.autograd.grad(
        gradients.score_gradient_loss(obs, K, *comps, noise=seeded()),
        params)
    assert any(not torch.allclose(a, b) for a, b in
               zip(pathwise_grads, score_grads))


def test_refused_options_raise():
    _, comps = _components()
    obs = tensor(simulate(0, 3, 2))
    noise = NoiseSource.seeded(0, device="cpu")
    with pytest.raises(ValueError, match="resampling_method='multinomial'"):
        gradients.score_gradient_loss(obs, 8, *comps, noise=noise,
                                      resampling_method="systematic")
    with pytest.raises(ValueError, match="resampling_criterion='always'"):
        gradients.score_gradient_loss(obs, 8, *comps, noise=noise,
                                      resampling_criterion=0.5)
    with pytest.raises(ValueError, match="lookahead"):
        gradients.score_gradient_loss(
            obs, 8, *comps, noise=noise,
            lookahead=lgssm.Lookahead(0.6, 1.0, 0.8, 0.5))
    with pytest.raises(ValueError, match="baseline"):
        gradients.score_gradient_loss(obs, 8, *comps, noise=noise,
                                      baseline="bogus")
    with pytest.raises(ValueError, match="return_log_weights"):
        gradients.score_surrogate_from_result(
            {"log_weights": None, "ancestral_indices": None})
    # Through the losses: the same refusals, and 'score' only for 'aesmc'.
    with pytest.raises(ValueError, match="resampling_method='multinomial'"):
        losses.get_loss(obs, 8, "aesmc", *comps, noise=noise,
                        gradient_estimator="score")
    with pytest.raises(ValueError, match="already unbiased"):
        losses.get_loss(obs, 8, "iwae", *comps, noise=noise,
                        gradient_estimator="score")
    with pytest.raises(ValueError, match="only applies"):
        losses.get_loss_and_metrics(obs, 8, "iwae", *comps, noise=noise,
                                    gradient_estimator="score")
    with pytest.raises(ValueError, match="requires resampling_method"):
        losses.get_loss_and_metrics(obs, 8, "aesmc", *comps, noise=noise,
                                    gradient_estimator="score")
    with pytest.raises(ValueError, match="requires resampling_criterion"):
        losses.get_loss_and_metrics(
            obs, 8, "aesmc", *comps, noise=noise, gradient_estimator="score",
            resampling_method="multinomial", resampling_criterion=0.5)
