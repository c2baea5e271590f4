"""The auxiliary particle filter (`lookahead`), and soft and residual
resampling inside `infer`, in the port against the JAX package.

The LGSSM goes through both packages (`lgssm.from_numpy`), on
observations made from a numpy seed; the JAX run's draws are replayed
into the port (the proposal's eps recovered from its latents, the
resampling noise redrawn from its keys) with the JAX package's CDF
patched in, so that the ancestors compare exactly.

Tolerances: ancestors exactly equal; log-Z and latents within 1e-4
absolute, the loss within 1e-3 and each gradient within 1e-3 relative
(1e-4 absolute) of the JAX package's, as `test_torch_losses.py` holds the
plain filter (the replayed eps is within an ulp of JAX's draw). With a
zero lookahead the port's filter equals its plain filter bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aesmc_tpu import inference as jax_inference
from aesmc_tpu import losses as jax_losses
from aesmc_tpu import resampling as jax_resampling
from aesmc_tpu.models import lgssm as jax_lgssm
from aesmc_tpu_torch import inference, losses, resampling, train
from aesmc_tpu_torch.models import lgssm
from aesmc_tpu_torch.noise import NoiseSource
from torch_replay import lgssm_params, replayed_noise, simulate, tensor

T, B, K = 6, 2, 48
CPU = "cpu"
TR_MULT, TR_SCALE, EM_MULT, EM_SCALE = 0.9, 1.0, 1.0, 0.5


@pytest.fixture(scope="module")
def models():
    jax_comps = (jax_lgssm.Initial(0.0, 1.0),
                 jax_lgssm.Transition.create(TR_MULT, TR_SCALE),
                 jax_lgssm.Emission.create(EM_MULT, EM_SCALE),
                 jax_lgssm.Proposal.create(1.0, 0.8, jax.random.PRNGKey(1)))
    return jax_comps, lgssm.from_numpy(lgssm_params(jax_comps), device=CPU)


@pytest.fixture
def jax_cdf(monkeypatch):
    def cdf(log_weight):
        return tensor(jax_resampling._normalized_cumsum(
            jnp.asarray(log_weight.detach().numpy())))

    monkeypatch.setattr(resampling, "_normalized_cumsum", cdf)


def _lookaheads():
    return (jax_lgssm.Lookahead.create(TR_MULT, TR_SCALE, EM_MULT, EM_SCALE),
            lgssm.Lookahead(TR_MULT, TR_SCALE, EM_MULT, EM_SCALE))


def _run_both(models, method, seed, lookahead=False):
    jax_comps, comps = models
    obs = simulate(seed, T, B, mult=TR_MULT, em_scale=EM_SCALE)
    key = jax.random.PRNGKey(seed)
    jax_look, look = _lookaheads() if lookahead else (None, None)
    want = jax_inference.infer(
        "smc", jnp.asarray(obs), *jax_comps, K, key=key, lookahead=jax_look,
        resampling_method=method, return_log_marginal_likelihood=True,
        return_original_latents=True, return_ancestral_indices=True,
        return_log_weights=True)
    noise = replayed_noise(jax_comps[3], obs, key, want["original_latents"],
                           want["ancestral_indices"], method)
    with torch.no_grad():
        got = inference.infer(
            "smc", tensor(obs), *comps, K, noise=noise, lookahead=look,
            resampling_method=method, return_log_marginal_likelihood=True,
            return_original_latents=True, return_ancestral_indices=True,
            return_log_weights=True)
    assert noise.exhausted()
    return want, got


def _assert_close(want, got):
    np.testing.assert_array_equal(got["ancestral_indices"].numpy(),
                                  np.asarray(want["ancestral_indices"]))
    for name in ("log_marginal_likelihood", "original_latents",
                 "log_weights"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   rtol=0, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("method", ["systematic", "multinomial"])
def test_apf_matches_jax(models, method, jax_cdf):
    _assert_close(*_run_both(models, method, 11, lookahead=True))


@pytest.mark.parametrize("method", ["soft", "residual"])
def test_soft_and_residual_filters_match_jax(models, method, jax_cdf):
    _assert_close(*_run_both(models, method, 12))


class _Zero:
    def __call__(self, previous_latents=None, time=None, observations=None):
        return torch.zeros_like(previous_latents[-1])


@pytest.mark.parametrize("route", ["torch", "kernel_wrappers"])
def test_zero_lookahead_is_the_plain_filter_bit_for_bit(models, route,
                                                        monkeypatch):
    _, comps = models
    if route == "kernel_wrappers":
        # The 'cuda' route's wrappers on CPU tensors: the scores ride K1
        # as a second column.
        monkeypatch.setattr(
            resampling, "_route",
            lambda device, implementation: "cuda")
    obs = tensor(simulate(13, T, B))
    outs = []
    for lookahead in (None, _Zero()):
        with torch.no_grad():
            outs.append(inference.infer(
                "smc", obs, *comps, K, noise=NoiseSource.seeded(5, CPU),
                lookahead=lookahead, return_log_marginal_likelihood=True,
                return_ancestral_indices=True))
    for name in ("log_marginal_likelihood", "latents", "log_weight",
                 "ancestral_indices"):
        assert torch.equal(outs[0][name], outs[1][name]), name


def test_apf_gradients_flow(models):
    _, comps = models
    params = lgssm_params(models[0])
    comps = lgssm.from_numpy(params, device=CPU)
    look = _lookaheads()[1]
    obs = tensor(simulate(14, T, B))
    loss = losses.get_loss(obs, K, "aesmc", *comps,
                           noise=NoiseSource.seeded(6, CPU), lookahead=look)
    loss.backward()
    for p in (look.transition_mult, look.emission_mult, comps[1].mult,
              comps[2].mult, comps[3].lin_t_weight):
        assert p.grad is not None and bool(torch.isfinite(p.grad).all())
        assert float(p.grad.abs().sum()) > 0


@pytest.mark.parametrize("kwargs,message", [
    (dict(algorithm="is", lookahead=True), "requires"),
    (dict(method="soft", lookahead=True), "does not combine"),
    (dict(method="soft", criterion=0.5), "ESS-adaptive"),
    (dict(window=0), "history_window"),
])
def test_validation_errors(models, kwargs, message):
    _, comps = models
    obs = tensor(simulate(15, 3, B))
    with pytest.raises(ValueError, match=message):
        inference.infer(
            kwargs.get("algorithm", "smc"), obs, *comps, 4,
            noise=NoiseSource.seeded(0, CPU),
            lookahead=_Zero() if kwargs.get("lookahead") else None,
            resampling_method=kwargs.get("method", "systematic"),
            resampling_criterion=kwargs.get("criterion", "always"),
            history_window=kwargs.get("window", 1))


def test_soft_loss_and_gradients_match_jax(models, jax_cdf, monkeypatch):
    jax_comps, _ = models
    comps = lgssm.from_numpy(lgssm_params(jax_comps), device=CPU)
    obs = simulate(16, T, B)
    key = jax.random.PRNGKey(16)

    def objective(learned):
        return jax_losses.get_loss(jnp.asarray(obs), K, "aesmc",
                                   jax_comps[0], *learned, key=key,
                                   resampling_method="soft",
                                   soft_resampling_alpha=0.5)

    loss, grads = jax.value_and_grad(objective)(tuple(jax_comps[1:]))
    out = jax_inference.infer("smc", jnp.asarray(obs), *jax_comps, K,
                              key=key, resampling_method="soft",
                              return_original_latents=True,
                              return_ancestral_indices=True)
    results = []
    for route in ("torch", "kernel_wrappers"):
        if route == "kernel_wrappers":
            monkeypatch.setattr(
                resampling, "_route",
                lambda device, implementation: "cuda")
        for p in train.get_chained_params(*comps):
            p.grad = None
        noise = replayed_noise(jax_comps[3], obs, key,
                               out["original_latents"],
                               out["ancestral_indices"], "soft")
        got = losses.get_loss(tensor(obs), K, "aesmc", *comps, noise=noise,
                              resampling_method="soft")
        got.backward()
        results.append((got.detach(), [p.grad.clone() for p in
                                       train.get_chained_params(*comps)]))
        np.testing.assert_allclose(float(got.detach()), float(loss), rtol=0,
                                   atol=1e-3)
        for module, jax_module, names in (
                (comps[1], grads[0], ("mult",)),
                (comps[2], grads[1], ("mult",)),
                (comps[3], grads[2], ("lin_0_weight", "lin_t_weight"))):
            for name in names:
                np.testing.assert_allclose(
                    getattr(module, name).grad.numpy(),
                    np.asarray(getattr(jax_module, name)), rtol=1e-3,
                    atol=1e-4, err_msg=name)
    # Both routes gather the same values: equal losses, and gradients
    # within 1e-5 relative (K2's plain version sums in its own order).
    (loss_t, grads_t), (loss_k, grads_k) = results
    assert torch.equal(loss_t, loss_k)
    for a, b in zip(grads_k, grads_t):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-6)


def test_soft_train_on_device_runs_eagerly_on_cpu(models):
    _, comps = models
    comps = lgssm.from_numpy(lgssm_params(models[0]), device=CPU)
    gen = (lgssm.Initial(0.0, 1.0), lgssm.Transition(TR_MULT, TR_SCALE),
           lgssm.Emission(EM_MULT, EM_SCALE))
    _, out = train.train_on_device(
        *comps, 16, "aesmc", gen, 4, B, 3,
        noise=NoiseSource.seeded(7, CPU), steps_per_call=3,
        resampling_method="soft", soft_resampling_alpha=0.7)
    assert out.shape == (3,) and bool(torch.isfinite(out).all())
