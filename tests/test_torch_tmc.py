"""The port's Tensor Monte Carlo estimator against the JAX package's.

TMC samples its particles as importance sampling does, from the same
keys (`split(key, (T, 2))[t, 1]`), so the JAX draws are recovered from a
JAX `infer('is', ...)` run's latents with the same key (eps by the port's
own proposal) and replayed into the port. LGSSM at T = 6, B = 2, K = 16;
the neural transition (an MLP that takes only rank-3 latents) at T = 5,
B = 2, D = 2, K = 8.

Tolerances: log-Z and the loss within 1e-4 absolute, gradients within
rtol 1e-4 / atol 1e-5 (the replayed eps is within an ulp of the JAX
draw; the two sum in different orders); one Adam step's parameters
within 1e-5; blocked against full: log-Z bit for bit, gradients within
rtol 1e-5 (the backward adds the blocks in another order); K = 1 against
IWAE: rtol 1e-6 (the same numbers summed in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from aesmc_tpu import inference as jax_inference
from aesmc_tpu import losses as jax_losses
from aesmc_tpu import tmc as jax_tmc
from aesmc_tpu import train as jax_train
from aesmc_tpu import distributions as jax_dists
from aesmc_tpu.models import lgssm as jax_lgssm
from aesmc_tpu.models import lgssm_nd as jax_lgssm_nd
from aesmc_tpu.state import BatchShapeMode as JaxMode
from aesmc_tpu.utils import mlp as jax_mlp
from aesmc_tpu_torch import distributions, losses, tmc, train
from aesmc_tpu_torch.models import lgssm, lgssm_nd
from aesmc_tpu_torch.noise import NoiseSource
from aesmc_tpu_torch.state import BatchShapeMode
from aesmc_tpu_torch.utils import MLP
from torch_replay import (ReplayNoise, fields, lgssm_params, mlp_fields,
                          proposal_eps, simulate, tensor)

T, B, K = 6, 2, 16
KEY = jax.random.PRNGKey(4)
LEAVES = (("transition", "mult"), ("emission", "mult"),
          ("proposal", "lin_0_weight"), ("proposal", "lin_0_bias"),
          ("proposal", "lin_t_weight"), ("proposal", "lin_t_bias"))


def _lgssm():
    jax_comps = (jax_lgssm.Initial(0.0, 1.0),
                 jax_lgssm.Transition.create(0.6, 1.0),
                 jax_lgssm.Emission.create(0.8, 0.5),
                 jax_lgssm.Proposal.create(1.0, 0.8, jax.random.PRNGKey(1)))
    return jax_comps, lgssm.from_numpy(lgssm_params(jax_comps), device="cpu")


def _replay(jax_comps, proposal, obs, key, k):
    """The JAX TMC run's proposal draws, as a `ReplayNoise`."""
    latents = jax_inference.infer("is", jnp.asarray(obs), *jax_comps, k,
                                  key=key)["latents"]
    return ReplayNoise(normals=proposal_eps(proposal, obs, latents, None))


@pytest.mark.parametrize("pairwise", ["broadcast", "vmap"])
def test_loss_and_gradients_match_jax(pairwise):
    jax_comps, comps = _lgssm()
    obs = simulate(3, T, B)

    def loss_fn(trainable):
        return jax_tmc.tmc_loss(jnp.asarray(obs), K, jax_comps[0],
                                *trainable, key=KEY, pairwise=pairwise)

    loss, grads = jax.value_and_grad(loss_fn)(tuple(jax_comps[1:]))
    noise = _replay(jax_comps, comps[3], obs, KEY, K)
    got = tmc.tmc_loss(tensor(obs), K, *comps, noise=noise,
                       pairwise=pairwise)
    got.backward()
    assert noise.exhausted()
    np.testing.assert_allclose(float(got.detach()), float(loss), atol=1e-4)
    modules = dict(zip(("initial", "transition", "emission", "proposal"),
                       comps))
    jax_grads = dict(zip(("transition", "emission", "proposal"), grads))
    for component, name in LEAVES:
        np.testing.assert_allclose(
            getattr(modules[component], name).grad.numpy(),
            np.asarray(getattr(jax_grads[component], name)),
            rtol=1e-4, atol=1e-5, err_msg=f"{component}.{name}")


def test_k1_equals_iwae():
    _, comps = _lgssm()
    obs = tensor(simulate(5, T, B))
    lml = tmc.tmc_log_marginal_likelihood(
        obs, *comps, 1, noise=NoiseSource.seeded(2, device="cpu"))
    iwae = -losses.get_loss(obs, 1, "iwae", *comps,
                            noise=NoiseSource.seeded(2, device="cpu"))
    np.testing.assert_allclose(float(lml.mean().detach()),
                               float(iwae.detach()), rtol=1e-6)


def test_blocked_equals_full_bit_for_bit():
    _, comps = _lgssm()
    obs = tensor(simulate(6, T, B))
    params = train.get_chained_params(*comps)
    results = []
    for block_size in (None, 4):
        lml = tmc.tmc_log_marginal_likelihood(
            obs, *comps, K, noise=NoiseSource.seeded(7, device="cpu"),
            block_size=block_size)
        results.append((lml, torch.autograd.grad(lml.sum(), params)))
    (full, full_grads), (blocked, blocked_grads) = results
    assert torch.equal(full, blocked)
    # The backward adds the blocks' contributions in another order.
    for a, b in zip(full_grads, blocked_grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-6)
    with pytest.raises(ValueError, match="block_size"):
        tmc.tmc_log_marginal_likelihood(
            obs, *comps, K, noise=NoiseSource.seeded(7, device="cpu"),
            block_size=5)
    with pytest.raises(ValueError, match="pairwise"):
        tmc.tmc_log_marginal_likelihood(
            obs, *comps, K, noise=NoiseSource.seeded(7, device="cpu"),
            pairwise="bogus")


class _JaxRankBound:
    """The JAX package's test transition (tests/test_tmc.py): an MLP that
    takes only rank-3 `[B, K, D]` latents."""

    def __init__(self, net):
        self.net = net

    def __call__(self, previous_latents=None, time=None,
                 previous_observations=None):
        prev = previous_latents[-1]
        b, k, d = prev.shape
        loc = self.net(prev.reshape(b * k, d)).reshape(b, k, d)
        return jax_dists.MultivariateNormalDiag(
            loc, 0.8 * jnp.ones_like(loc),
            batch_shape_mode=JaxMode.FULLY_EXPANDED)


class _RankBound(torch.nn.Module):
    def __init__(self, net):
        super().__init__()
        self.net = net

    def forward(self, previous_latents=None, time=None,
                previous_observations=None):
        prev = previous_latents[-1]
        b, k, d = prev.shape
        loc = self.net(prev.reshape(b * k, d)).reshape(b, k, d)
        return distributions.MultivariateNormalDiag(
            loc, 0.8 * torch.ones_like(loc),
            batch_shape_mode=BatchShapeMode.FULLY_EXPANDED)


def test_neural_transition_auto_finds_vmap():
    dim, k = 2, 8
    net = jax_mlp.MLP.create((dim, 8, dim), jax.random.PRNGKey(9))
    jax_comps = (jax_lgssm_nd.Initial.create(dim), _JaxRankBound(net),
                 jax_lgssm_nd.Emission.create(np.eye(dim), 0.3),
                 jax_lgssm_nd.Proposal.create(dim, dim,
                                              jax.random.PRNGKey(10)))
    obs = np.asarray(jax.random.normal(jax.random.PRNGKey(11), (5, B, dim)))
    want = jax_tmc.tmc_log_marginal_likelihood(
        jnp.asarray(obs), *jax_comps, k, key=KEY, pairwise="vmap")
    nd = lgssm_nd.from_numpy(
        {"initial": fields(jax_comps[0]), "transition": {
            "matrix": np.eye(dim), "scale": None, "frozen_scale": 1.0},
         "emission": fields(jax_comps[2]),
         "proposal": fields(jax_comps[3])}, device="cpu")
    comps = (nd[0], _RankBound(MLP.from_numpy(**mlp_fields(net),
                                              device="cpu")), nd[2], nd[3])
    with pytest.raises(Exception):
        tmc.tmc_log_marginal_likelihood(
            tensor(obs), *comps, k, noise=NoiseSource.seeded(0, "cpu"),
            pairwise="broadcast")
    latent_0 = torch.zeros(B, k, dim)
    assert tmc._resolve_pairwise_mode(comps[1], latent_0,
                                      tensor(obs[0])) == "vmap"
    got = {}
    for pairwise in ("vmap", "auto"):
        noise = _replay(jax_comps, comps[3], obs, KEY, k)
        got[pairwise] = tmc.tmc_log_marginal_likelihood(
            tensor(obs), *comps, k, noise=noise, pairwise=pairwise)
        assert noise.exhausted()
    assert torch.equal(got["vmap"], got["auto"])
    np.testing.assert_allclose(got["vmap"].detach().numpy(),
                               np.asarray(want), atol=1e-4)
    got["auto"].sum().backward()
    norms = [float(w.grad.norm()) for w in comps[1].net.weights]
    assert all(np.isfinite(n) and n > 0 for n in norms)


def test_get_loss_and_train_step_match_jax():
    """'tmc' through `get_loss`, `get_loss_and_metrics` and one
    `make_train_step` (Adam, lr 1e-2) against the JAX package's."""
    jax_comps, comps = _lgssm()
    obs = simulate(8, T, B)
    want = jax_losses.get_loss(jnp.asarray(obs), K, "tmc", *jax_comps,
                               key=KEY)
    got = losses.get_loss(tensor(obs), K, "tmc", *comps,
                          noise=_replay(jax_comps, comps[3], obs, KEY, K),
                          resampling_method="multinomial")
    np.testing.assert_allclose(float(got.detach()), float(want), atol=1e-4)
    loss, metrics = losses.get_loss_and_metrics(
        tensor(obs), K, "tmc", *comps,
        noise=_replay(jax_comps, comps[3], obs, KEY, K))
    assert torch.equal(loss.detach(), got.detach())
    assert torch.isnan(metrics["ess"]) and torch.equal(metrics["elbo"],
                                                       -got.detach())
    error, checked = losses.checked_loss(
        tensor(obs), K, "tmc", *comps,
        noise=_replay(jax_comps, comps[3], obs, KEY, K))
    assert error.get() is None and torch.equal(checked, got)

    optimizer = optax.adam(1e-2)
    jax_step = jax_train.make_train_step(K, "tmc", optimizer, jit=False)
    new_comps, _, jax_loss = jax_step(tuple(jax_comps),
                                      optimizer.init(tuple(jax_comps)),
                                      jnp.asarray(obs), KEY)
    step = train.make_train_step(K, "tmc", torch.optim.Adam(
        train.get_chained_params(*comps), lr=1e-2), pairwise="broadcast")
    port_loss = step(comps, tensor(obs),
                     _replay(jax_comps, comps[3], obs, KEY, K))
    np.testing.assert_allclose(float(port_loss), float(jax_loss), atol=1e-4)
    modules = dict(zip(("initial", "transition", "emission", "proposal"),
                       comps))
    jax_new = dict(zip(("initial", "transition", "emission", "proposal"),
                       new_comps))
    for component, name in LEAVES:
        np.testing.assert_allclose(
            getattr(modules[component], name).detach().numpy(),
            np.asarray(getattr(jax_new[component], name)), atol=1e-5,
            err_msg=f"{component}.{name}")
