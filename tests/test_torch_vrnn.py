"""The port's VRNN (and its MLP, GRU and mixed-precision product) against
the JAX package's.

`vrnn.from_numpy` carries the JAX model's parameters across (latent 3,
GRU hidden 8, observations 4, MLP hidden 8). `generate` replays the JAX
draws (its key schedule: z_0, y_0, then z_t, y_t a step); `vrnn_loss`
replays a JAX filter's draws (the proposal's eps recovered from its
latents by the port's own bound proposal, the resampling uniforms from
its keys, the JAX package's CDF patched in so that the ancestors compare
exactly) at T = 6, B = 2, K = 16.

Tolerances: parameters exactly equal; generated latents and observations
within 1e-5 absolute; the loss within 1e-4 absolute and every gradient
within rtol 1e-3 / atol 1e-4 (float32 sums in different orders through a
GRU, two MLPs and T steps); the bf16 product within 1e-5 relative of
JAX's (the same bf16-rounded inputs, float32 accumulation in another
order), and at least 1e-4 relative off the float32 product (the inputs
were rounded).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aesmc_tpu import inference as jax_inference
from aesmc_tpu import resampling as jax_resampling
from aesmc_tpu.models import vrnn as jax_vrnn
from aesmc_tpu.utils import mlp as jax_mlp
from aesmc_tpu_torch import inference, resampling, train
from aesmc_tpu_torch.models import vrnn
from aesmc_tpu_torch.noise import NoiseSource
from aesmc_tpu_torch.utils import mlp
from torch_replay import (ReplayNoise, normal_draw, proposal_eps,
                          resampling_draws, tensor, vrnn_params)

LATENT, HIDDEN, OBS, MLP_HIDDEN = 3, 8, 4, 8
T, B, K = 6, 2, 16
KEY = jax.random.PRNGKey(3)


def _models(compute_dtype=None):
    jax_model = jax_vrnn.make_model(LATENT, HIDDEN, OBS, key=KEY,
                                    mlp_hidden=MLP_HIDDEN,
                                    compute_dtype=compute_dtype)
    model = vrnn.from_numpy(vrnn_params(jax_model),
                            compute_dtype=compute_dtype, device="cpu")
    return jax_model, model


def _generate_draws(key, num_timesteps, batch):
    """`jax_vrnn.generate`'s normal draws, in the port's order and
    layout: z_0 and y_0, then z_t and y_t a step, each `[B, 1, D]`."""
    k0, key = jax.random.split(key)
    ke, key = jax.random.split(key)
    draws = [normal_draw(k0, (batch,), (LATENT,)),
             normal_draw(ke, (batch, OBS))]
    for k in jax.random.split(key, num_timesteps - 1):
        kz, ky = jax.random.split(k)
        draws += [normal_draw(kz, (batch, LATENT)),
                  normal_draw(ky, (batch, OBS))]
    return [d[:, None, :] for d in draws]


def test_from_numpy_round_trip():
    jax_model, model = _models()
    initial, encoder, transition, emission, proposal = model
    cell = jax_model[1].cell
    for name in ("w_ru", "b_ru", "w_c", "b_c"):
        np.testing.assert_array_equal(
            getattr(encoder.cell, name).detach().numpy(),
            np.asarray(getattr(cell, name)))
    for port_mlp, jax_net in ((transition.prior_net, jax_model[2].prior_net),
                              (emission.decoder, jax_model[3].decoder),
                              (proposal.encoder_net,
                               jax_model[4].encoder_net)):
        for got, want in zip(port_mlp.weights, jax_net.weights):
            np.testing.assert_array_equal(got.detach().numpy(),
                                          np.asarray(want))
        assert [tuple(w.shape) for w in port_mlp.weights] == [
            tuple(np.shape(w)) for w in jax_net.weights]
    np.testing.assert_array_equal(emission.log_noise.detach().numpy(),
                                  np.asarray(jax_model[3].log_noise))
    assert len(train.get_chained_params(encoder, transition, emission,
                                        proposal)) == 17


def test_generate_replays_jax():
    jax_model, model = _models()
    key = jax.random.PRNGKey(7)
    jax_z, jax_y = jax_vrnn.generate(jax_model[1], jax_model[0],
                                     jax_model[2], jax_model[3], T, B, key)
    noise = ReplayNoise(normals=_generate_draws(key, T, B))
    with torch.no_grad():
        z, y = vrnn.generate(model[1], model[0], model[2], model[3], T, B,
                             noise)
    assert noise.exhausted()
    assert z.shape == (T, B, LATENT) and y.shape == (T, B, OBS)
    np.testing.assert_allclose(z.numpy(), np.asarray(jax_z), atol=1e-5)
    np.testing.assert_allclose(y.numpy(), np.asarray(jax_y), atol=1e-5)


@pytest.mark.parametrize("algorithm,route", [
    ("iwae", "torch"), ("aesmc", "torch"), ("aesmc", "kernel_wrappers")])
def test_loss_and_gradients_match_jax(algorithm, route, monkeypatch):
    jax_model, model = _models()
    _, obs = jax_vrnn.generate(jax_model[1], jax_model[0], jax_model[2],
                               jax_model[3], T, B, jax.random.PRNGKey(8))
    obs = np.asarray(obs)
    key = jax.random.PRNGKey(9)

    def jax_loss(trainable):
        return jax_vrnn.vrnn_loss(jnp.asarray(obs), K, algorithm,
                                  jax_model[0], *trainable, key=key,
                                  resampling_implementation="xla")

    loss, grads = jax.value_and_grad(jax_loss)(tuple(jax_model[1:]))
    is_smc = algorithm == "aesmc"
    bound = jax_vrnn.bind(*jax_model[1:], jnp.asarray(obs))
    out = jax_inference.infer(
        "smc" if is_smc else "is", jnp.asarray(obs), jax_model[0], *bound,
        K, key=key, resampling_implementation="xla",
        return_original_latents=is_smc, return_ancestral_indices=is_smc)
    latents = out["original_latents"] if is_smc else out["latents"]
    ancestors = out["ancestral_indices"] if is_smc else None

    monkeypatch.setattr(resampling, "_normalized_cumsum", lambda lw: tensor(
        jax_resampling._normalized_cumsum(jnp.asarray(lw.detach().numpy()))))
    if route == "kernel_wrappers":
        # The 'cuda' route's wrappers on CPU tensors: K1 over the 3 latent
        # columns, K2's plain version as its backward.
        monkeypatch.setattr(resampling, "resolve_implementation",
                            lambda *args: "cuda")
    with torch.no_grad():
        port_bound = vrnn.bind(*model[1:], tensor(obs))
    eps = proposal_eps(port_bound[2], obs, latents, ancestors)
    draws = (resampling_draws(key, T, B, K, "systematic") if is_smc
             else {})
    noise = ReplayNoise(normals=eps, **draws)
    got = vrnn.vrnn_loss(tensor(obs), K, algorithm, *model, noise=noise)
    got.backward()
    assert noise.exhausted()
    np.testing.assert_allclose(float(got.detach()), float(loss), atol=1e-4)
    encoder, transition, emission, proposal = model[1:]
    jax_enc, jax_tr, jax_em, jax_prop = grads
    pairs = [(getattr(encoder.cell, n), getattr(jax_enc.cell, n))
             for n in ("w_ru", "b_ru", "w_c", "b_c")]
    for port_mlp, jax_net in ((transition.prior_net, jax_tr.prior_net),
                              (emission.decoder, jax_em.decoder),
                              (proposal.encoder_net, jax_prop.encoder_net)):
        pairs += list(zip(port_mlp.weights, jax_net.weights))
        pairs += list(zip(port_mlp.biases, jax_net.biases))
    pairs.append((emission.log_noise, jax_em.log_noise))
    for got_p, want in pairs:
        np.testing.assert_allclose(got_p.grad.numpy(), np.asarray(want),
                                   rtol=1e-3, atol=1e-4)


def test_bf16_mixed_dot_matches_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 5, 24).astype(np.float32)
    w = rng.randn(24, 7).astype(np.float32)
    want = np.asarray(jax_mlp.mixed_dot(jnp.asarray(x), jnp.asarray(w),
                                        "bfloat16"))
    got = mlp.mixed_dot(torch.tensor(x), torch.tensor(w), "bfloat16")
    assert got.dtype == torch.float32 and got.shape == (2, 5, 7)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    full = x @ w
    assert np.abs(got.numpy() - full).max() > 1e-4 * np.abs(full).max()

    # Gradients through the bf16 product: the cotangent multiplies the
    # same rounded inputs.
    xt = torch.tensor(x, requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    mlp.mixed_dot(xt, wt, "bfloat16").sum().backward()
    gx, gw = jax.grad(lambda a, b: jnp.sum(jax_mlp.mixed_dot(
        a, b, "bfloat16")), argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=1e-2,
                               atol=1e-2)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(gw), rtol=1e-2,
                               atol=1e-2)


def test_bf16_loss_matches_jax():
    """The whole VRNN objective with bf16 products: within 1e-2 of the JAX
    package's (bf16 inputs give ~3 significant digits a product)."""
    jax_model, model = _models("bfloat16")
    _, obs = jax_vrnn.generate(jax_model[1], jax_model[0], jax_model[2],
                               jax_model[3], T, B, jax.random.PRNGKey(8))
    obs = np.asarray(obs)
    key = jax.random.PRNGKey(10)
    loss = jax_vrnn.vrnn_loss(jnp.asarray(obs), K, "iwae", *jax_model,
                              key=key)
    out = jax_inference.infer("is", jnp.asarray(obs), jax_model[0],
                              *jax_vrnn.bind(*jax_model[1:],
                                             jnp.asarray(obs)), K, key=key)
    with torch.no_grad():
        port_bound = vrnn.bind(*model[1:], tensor(obs))
        eps = proposal_eps(port_bound[2], obs, out["latents"], None)
        got = vrnn.vrnn_loss(tensor(obs), K, "iwae", *model,
                             noise=ReplayNoise(normals=eps))
    np.testing.assert_allclose(float(got), float(loss), atol=1e-2)


def test_bind_on_call_equals_bind():
    """The components of `bind_on_call` (which encode the observations at
    the proposal's t = 0 call) give `vrnn_loss`'s loss and gradients on
    the same noise, bit for bit."""
    _, model = _models()
    obs = torch.tensor(np.random.RandomState(1).randn(T, B, OBS),
                       dtype=torch.float32)
    params = train.get_chained_params(*model[1:])
    want = vrnn.vrnn_loss(obs, K, "aesmc", *model,
                          noise=NoiseSource.seeded(5, device="cpu"))
    want_grads = torch.autograd.grad(want, params)
    comps = vrnn.bind_on_call(*model)
    assert train.get_chained_params(*comps) is not None
    assert {id(p) for p in train.get_chained_params(*comps)} == {
        id(p) for p in params}
    got = inference.infer(
        "smc", obs, *comps, K, noise=NoiseSource.seeded(5, device="cpu"),
        return_log_marginal_likelihood=True,
        return_latents=False)["log_marginal_likelihood"]
    got = -got.mean()
    got_grads = torch.autograd.grad(got, params)
    assert torch.equal(got, want)
    for a, b in zip(got_grads, want_grads):
        assert torch.equal(a, b)
    # The user's modules stay unbound.
    assert model[2].h_seq is None and model[4].h_seq is None
