"""The port's bouncing-ball model (`aesmc_tpu_torch.models.bouncing_ball`)
against the JAX package's.

`from_numpy` carries the JAX model's parameters across (MLP weights in
the JAX `[in, out]` layout, the log-noises) at num_pixels = 16, hidden =
32. The filter and the AESMC loss replay a JAX run's draws (the
proposal's eps recovered from its latents by the port's own proposal, the
resampling uniforms from its keys, the JAX package's CDF patched in so
that the ancestors compare exactly) at (T, B, K) = (6, 2, 16).

Tolerances: the functions and every component's distribution within 1e-6
(a few ulps of the same float32 expressions); ancestors exactly equal;
log-Z and the loss within 1e-5 relative; each gradient within 1e-5 of
its tensor's largest entry (float32 sums through two MLPs and T steps in
another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aesmc_tpu import inference as jax_inference
from aesmc_tpu import losses as jax_losses
from aesmc_tpu import resampling as jax_resampling
from aesmc_tpu import statistics as jax_statistics
from aesmc_tpu.models import bouncing_ball as jax_bb
from aesmc_tpu_torch import inference, losses, resampling, train
from aesmc_tpu_torch.models import bouncing_ball
from torch_replay import (ReplayNoise, mlp_fields, proposal_eps,
                          resampling_draws, tensor)

PIXELS, HIDDEN = 16, 32
T, B, K = 6, 2, 16
TOL = dict(rtol=1e-6, atol=1e-6)


def bb_params(jax_model):
    """`bouncing_ball.from_numpy`'s argument for the JAX model."""
    initial, transition, emission, proposal = jax_model
    return {
        "initial": {"position_scale": initial.position_scale,
                    "velocity_scale": initial.velocity_scale},
        "transition": {"log_pos_noise": np.asarray(transition.log_pos_noise),
                       "log_vel_noise": np.asarray(transition.log_vel_noise)},
        "emission": {"decoder": mlp_fields(emission.decoder),
                     "log_noise": np.asarray(emission.log_noise),
                     "num_pixels": emission.num_pixels,
                     "use_decoder": emission.use_decoder},
        "proposal": {"encoder_0": mlp_fields(proposal.encoder_0),
                     "encoder_t": mlp_fields(proposal.encoder_t)},
    }


def _models(use_decoder=True):
    jax_model = jax_bb.make_model(jax.random.PRNGKey(0), num_pixels=PIXELS,
                                  hidden=HIDDEN)
    # A nonzero decoder output layer, so that the residual is exercised.
    emission = jax_model[2]
    decoder = emission.decoder.replace(weights=(
        emission.decoder.weights[0],
        0.1 * jax.random.normal(jax.random.PRNGKey(7),
                                emission.decoder.weights[1].shape)))
    jax_model = jax_model[:2] + (emission.replace(
        decoder=decoder, use_decoder=use_decoder),) + jax_model[3:]
    return jax_model, bouncing_ball.from_numpy(bb_params(jax_model),
                                               device="cpu")


def test_functions_match_jax():
    p = np.linspace(-3.0, 3.0, 61, dtype=np.float32)
    for fn in ("reflect", "reflected_velocity_sign"):
        np.testing.assert_allclose(
            getattr(bouncing_ball, fn)(torch.tensor(p)).numpy(),
            np.asarray(getattr(jax_bb, fn)(jnp.asarray(p))), **TOL)
    np.testing.assert_allclose(
        bouncing_ball.render(torch.tensor(p), PIXELS).numpy(),
        np.asarray(jax_bb.render(jnp.asarray(p), PIXELS)), **TOL)


def _distributions(model, lib, x, y):
    from aesmc_tpu.inference import ObservationSequence as JaxSeq
    from aesmc_tpu_torch.inference import ObservationSequence, TimeIndex
    initial, transition, emission, proposal = model
    seq, time = ((JaxSeq(y), 1) if lib == "jax" else
                 (ObservationSequence(y), TimeIndex(1)))
    return [initial(),
            transition(previous_latents=[x], time=time),
            emission(latents=[x], time=time),
            proposal(time=0, observations=seq),
            proposal(previous_latents=[x], time=time, observations=seq)]


@pytest.mark.parametrize("use_decoder", [True, False])
def test_from_numpy_gives_equal_distributions(use_decoder):
    jax_model, model = _models(use_decoder)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(B, K, 2)).astype(np.float32)
    y = rng.normal(size=(3, B, PIXELS)).astype(np.float32)
    with torch.no_grad():
        got = _distributions(model, "torch", torch.tensor(x),
                             torch.tensor(y))
    want = _distributions(jax_model, "jax", jnp.asarray(x), jnp.asarray(y))
    for g, w in zip(got, want):
        assert (getattr(g.batch_shape_mode, "name", None) ==
                getattr(w.batch_shape_mode, "name", None))
        np.testing.assert_allclose(g.loc.numpy(), np.asarray(w.loc), **TOL)
        np.testing.assert_allclose(g.scale_diag.numpy(),
                                   np.asarray(w.scale_diag), **TOL)


@pytest.fixture
def jax_cdf(monkeypatch):
    monkeypatch.setattr(resampling, "_normalized_cumsum", lambda lw: tensor(
        jax_resampling._normalized_cumsum(jnp.asarray(lw.detach().numpy()))))


def _replay(jax_model, model, obs, key):
    out = jax.jit(lambda o, k: jax_inference.infer(
        "smc", o, *jax_model, K, key=k, return_original_latents=True,
        return_ancestral_indices=True,
        return_log_marginal_likelihood=True))(jnp.asarray(obs), key)
    latents, ancestors = out["original_latents"], out["ancestral_indices"]
    eps = proposal_eps(model[3], obs, latents, ancestors)
    return out, ReplayNoise(normals=eps, **resampling_draws(
        key, T, B, K, "systematic"))


@pytest.fixture(scope="module")
def observations():
    jax_model, _ = _models()
    _, obs = jax_statistics.sample_from_prior(*jax_model[:3], T, B,
                                              jax.random.PRNGKey(3))
    return np.asarray(obs)


def test_infer_matches_jax(observations, jax_cdf):
    jax_model, model = _models()
    want, noise = _replay(jax_model, model, observations,
                          jax.random.PRNGKey(4))
    with torch.no_grad():
        out = inference.infer("smc", tensor(observations), *model, K,
                              noise=noise, return_ancestral_indices=True,
                              return_log_marginal_likelihood=True)
    assert noise.exhausted()
    np.testing.assert_array_equal(out["ancestral_indices"].numpy(),
                                  np.asarray(want["ancestral_indices"]))
    np.testing.assert_allclose(out["log_marginal_likelihood"].numpy(),
                               np.asarray(want["log_marginal_likelihood"]),
                               rtol=1e-5)


def test_aesmc_loss_and_gradients_match_jax(observations, jax_cdf):
    jax_model, model = _models()
    key = jax.random.PRNGKey(5)
    obs = jnp.asarray(observations)

    def loss_fn(trainable):
        return jax_losses.get_loss(obs, K, "aesmc", jax_model[0],
                                   *trainable, key=key)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
        tuple(jax_model[1:]))
    _, noise = _replay(jax_model, model, observations, key)
    got = losses.get_loss(tensor(observations), K, "aesmc", *model,
                          noise=noise)
    got.backward()
    assert noise.exhausted()
    np.testing.assert_allclose(float(got.detach()), float(loss), rtol=1e-5)
    transition, emission, proposal = model[1:]
    jax_tr, jax_em, jax_prop = grads
    pairs = [(transition.log_pos_noise, jax_tr.log_pos_noise),
             (transition.log_vel_noise, jax_tr.log_vel_noise),
             (emission.log_noise, jax_em.log_noise)]
    for port_mlp, jax_mlp in ((emission.decoder, jax_em.decoder),
                              (proposal.encoder_0, jax_prop.encoder_0),
                              (proposal.encoder_t, jax_prop.encoder_t)):
        pairs += list(zip(port_mlp.weights, jax_mlp.weights))
        pairs += list(zip(port_mlp.biases, jax_mlp.biases))
    assert len(train.get_chained_params(*model)) == len(pairs) == 15
    for param, want in pairs:
        want = np.asarray(want)
        np.testing.assert_allclose(param.grad.numpy(), want, rtol=0,
                                   atol=1e-5 * max(np.abs(want).max(), 1.0))
