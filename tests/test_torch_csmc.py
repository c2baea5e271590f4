"""The port's conditional SMC, particle Gibbs and PMMH
(`aesmc_tpu_torch.csmc`) against the JAX package's.

Every draw is replayed from the JAX key schedule: a sweep's
`split(key, (T, 3))[t]` streams (the ancestors' exponentials, the
proposal's normals, ancestor sampling's Gumbels), the trajectory pick's
Gumbel, `infer`'s `split(key, (T, 2))[t]` streams for particle Gibbs's
initial reference and PMMH's sweeps, and PMMH's random-walk normals and
accept uniform. On the LGSSM at (T, B, K) = (6, 2, 16): ancestors,
trajectories and accept decisions exactly equal; latents within 1e-5
absolute and log-Z within 1e-5 relative (float32 sums in other orders);
slot 0 holds the reference exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aesmc_tpu import csmc as jax_csmc
from aesmc_tpu import distributions as jax_dists
from aesmc_tpu import resampling as jax_resampling
from aesmc_tpu import state as jax_state
from aesmc_tpu import statistics as jax_statistics
from aesmc_tpu.models import lgssm as jax_lgssm
from aesmc_tpu_torch import csmc, distributions, state
from aesmc_tpu_torch.models import lgssm
from torch_replay import (ReplayNoise, lgssm_params, normal_draw,
                          resampling_draws, tensor)

T, B, K = 6, 2, 16
KEY = jax.random.PRNGKey(5)


def _models():
    jax_comps = (jax_lgssm.Initial(0.0, 1.0),
                 jax_lgssm.Transition.create(0.9, 1.0),
                 jax_lgssm.Emission.create(1.0, 0.5),
                 jax_lgssm.Proposal.create(0.8, 0.7, jax.random.PRNGKey(1)))
    return jax_comps, lgssm.from_numpy(lgssm_params(jax_comps), device="cpu")


def _sweep_draws(key, ancestor_sampling):
    """A conditional-SMC sweep's draws from ``key``."""
    step_keys = jax.random.split(key, (T, 3))
    draws = {"normals": [normal_draw(step_keys[0, 1], (K,), (B,), True)],
             "exponentials": [], "gumbels": []}
    for t in range(1, T):
        draws["exponentials"].append(np.asarray(
            jax.random.exponential(step_keys[t, 0], (B, K))))
        if ancestor_sampling:
            draws["gumbels"].append(np.asarray(
                jax.random.gumbel(step_keys[t, 2], (B, K))))
        draws["normals"].append(normal_draw(step_keys[t, 1], (B, K)))
    return draws


def _infer_draws(key):
    """`infer('smc')`'s draws from ``key`` (systematic resampling)."""
    step_keys = jax.random.split(key, (T, 2))
    normals = [normal_draw(step_keys[0, 1], (K,), (B,), True)]
    normals += [normal_draw(step_keys[t, 1], (B, K)) for t in range(1, T)]
    return dict(normals=normals, **resampling_draws(key, T, B, K,
                                                    "systematic"))


def _merge(*draw_sets):
    out = {}
    for draws in draw_sets:
        for kind, values in draws.items():
            out.setdefault(kind, []).extend(values)
    return out


def _gumbel(key):
    return {"gumbels": [np.asarray(jax.random.gumbel(key, (B, K)))]}


@pytest.fixture(scope="module")
def data():
    jax_comps, _ = _models()
    lat, obs = jax_statistics.sample_from_prior(*jax_comps[:3], T, B,
                                                jax.random.PRNGKey(2))
    return np.asarray(lat), np.asarray(obs)


@pytest.fixture(scope="module")
def sweeps(data):
    """The JAX sweeps, once: {ancestor_sampling: output}."""
    jax_comps, _ = _models()
    lat, obs = data
    return {a: jax.jit(lambda o, r, k, a=a: jax_csmc.csmc_infer(
        o, *jax_comps, K, r, key=k, ancestor_sampling=a))(obs, lat, KEY)
        for a in (False, True)}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_conditional_ancestors_exact(seed):
    rng = np.random.default_rng(seed)
    log_w = (rng.normal(size=(3, 40)) * (1 + 3 * seed)).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    want = jax_csmc._conditional_ancestors(jnp.asarray(log_w), key)
    noise = ReplayNoise(exponentials=[np.asarray(
        jax.random.exponential(key, (3, 40)))])
    got = csmc._conditional_ancestors(torch.tensor(log_w), noise)
    assert got.dtype == torch.int32 and noise.exhausted()
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got[:, 0] == 0).all()


@pytest.mark.parametrize("ancestor_sampling", [False, True])
def test_csmc_infer_matches_jax(ancestor_sampling, data, sweeps):
    lat, obs = data
    want = sweeps[ancestor_sampling]
    noise = ReplayNoise(**_sweep_draws(KEY, ancestor_sampling))
    out = csmc.csmc_infer(tensor(obs), *_models()[1], K, tensor(lat),
                          noise=noise, ancestor_sampling=ancestor_sampling)
    assert noise.exhausted()
    latents = out["original_latents"].detach()
    np.testing.assert_array_equal(latents[:, :, 0].numpy(), lat)
    np.testing.assert_array_equal(out["ancestral_indices"].numpy(),
                                  np.asarray(want["ancestral_indices"]))
    np.testing.assert_allclose(latents.numpy(),
                               np.asarray(want["original_latents"]),
                               atol=1e-5)
    np.testing.assert_allclose(
        out["log_marginal_likelihood"].detach().numpy(),
        np.asarray(want["log_marginal_likelihood"]), rtol=1e-5)
    np.testing.assert_allclose(out["log_weight"].detach().numpy(),
                               np.asarray(want["log_weight"]), rtol=1e-5,
                               atol=1e-5)


def test_sample_trajectory_matches_jax(sweeps):
    want = sweeps[True]
    key = jax.random.PRNGKey(9)
    traj = jax_csmc.sample_trajectory(want["original_latents"],
                                      want["ancestral_indices"],
                                      want["log_weight"], key)
    got = csmc.sample_trajectory(tensor(want["original_latents"]),
                                 tensor(want["ancestral_indices"]),
                                 tensor(want["log_weight"]),
                                 ReplayNoise(**_gumbel(key)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(traj))
    # T = 1 picks from the one step.
    one = csmc.sample_trajectory(tensor(want["original_latents"])[:1],
                                 torch.zeros((0, B, K), dtype=torch.int32),
                                 tensor(want["log_weight"]),
                                 ReplayNoise(**_gumbel(key)))
    want_one = jax_csmc.sample_trajectory(
        want["original_latents"][:1], want["ancestral_indices"][:0],
        want["log_weight"], key)
    assert one.shape == (1, B)
    np.testing.assert_array_equal(one.numpy(), np.asarray(want_one))


def test_particle_gibbs_three_iterations_match_jax(data):
    """The chain from the default initial reference (a lineage of one
    bootstrap `infer`): the same trajectories, and finite log-Zs within
    1e-5 relative."""
    jax_comps, comps = _models()
    _, obs = data
    key = jax.random.PRNGKey(11)
    trajs, lmls = jax.jit(lambda o, k: jax_csmc.particle_gibbs(
        o, *jax_comps, K, 3, key=k, ancestor_sampling=True))(obs, key)
    k_init, k_chain = jax.random.split(key)
    draws = [_infer_draws(k_init), _gumbel(jax.random.fold_in(k_init, 1))]
    for k in jax.random.split(k_chain, 3):
        k_sweep, k_pick = jax.random.split(k)
        draws += [_sweep_draws(k_sweep, True), _gumbel(k_pick)]
    noise = ReplayNoise(**_merge(*draws))
    got, got_lmls = csmc.particle_gibbs(tensor(obs), *comps, K, 3,
                                        noise=noise)
    assert noise.exhausted()
    assert got.shape == (3, T, B) and got_lmls.shape == (3, B)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(trajs),
                               atol=1e-5)
    np.testing.assert_allclose(got_lmls.detach().numpy(), np.asarray(lmls),
                               rtol=1e-5)


def _pmmh_components(lib):
    if lib == "jax":
        d, mode, prop = jax_dists, jax_state.BatchShapeMode, _models()[0][3]
    else:
        d, mode, prop = distributions, state.BatchShapeMode, _models()[1][3]

    def build(theta):
        def transition(previous_latents=None, time=None,
                       previous_observations=None):
            return d.Normal(theta["mult"] * previous_latents[-1], 1.0,
                            batch_shape_mode=mode.FULLY_EXPANDED)

        def emission(latents=None, time=None, previous_observations=None):
            return d.Normal(theta["em"] * latents[-1], 0.5,
                            batch_shape_mode=mode.FULLY_EXPANDED)

        return (lambda: d.Normal(0.0, 1.0)), transition, emission, prop

    def log_prior(theta):
        return -0.5 * (theta["mult"] ** 2 + theta["em"] ** 2)

    return build, log_prior


def test_pmmh_three_iterations_match_jax(data, monkeypatch):
    """The same proposals and accept decisions: the JAX CDF is patched in,
    so that the sweeps' ancestors, and with them the log-Z estimates on
    which each decision turns, are exact."""
    from aesmc_tpu_torch import resampling
    monkeypatch.setattr(resampling, "_normalized_cumsum", lambda lw: tensor(
        jax_resampling._normalized_cumsum(jnp.asarray(lw.detach().numpy()))))
    _, obs = data
    key = jax.random.PRNGKey(13)
    theta0 = {"mult": 0.5, "em": 0.8}
    build, log_prior = _pmmh_components("jax")
    thetas, lps, rate = jax.jit(lambda o, k: jax_csmc.pmmh(
        o, build, {name: jnp.float32(v) for name, v in theta0.items()},
        log_prior, K, 3, key=k, step_size=0.3))(obs, key)
    k_init, k_chain = jax.random.split(key)
    draws = [_infer_draws(k_init)]
    for k in jax.random.split(k_chain, 3):
        k_prop, k_run, k_acc = jax.random.split(k, 3)
        draws.append({"normals": [np.asarray(jax.random.normal(nk, ()))
                                  for nk in jax.random.split(k_prop, 2)]})
        draws.append(_infer_draws(k_run))
        draws.append({"uniforms": [np.asarray(jax.random.uniform(k_acc,
                                                                 ()))]})
    noise = ReplayNoise(**_merge(*draws))
    build, log_prior = _pmmh_components("torch")
    got, got_lps, got_rate = csmc.pmmh(tensor(obs), build, theta0,
                                       log_prior, K, 3, noise=noise,
                                       step_size=0.3)
    assert noise.exhausted()
    for name in theta0:
        assert got[name].shape == (3,)
        np.testing.assert_allclose(got[name].numpy(),
                                   np.asarray(thetas[name]), rtol=1e-6)
    np.testing.assert_allclose(got_lps.numpy(), np.asarray(lps), rtol=1e-5)
    assert float(got_rate) == float(rate)


def test_csmc_needs_two_particles(data):
    lat, obs = data
    with pytest.raises(ValueError, match="num_particles >= 2"):
        csmc.csmc_infer(tensor(obs), *_models()[1], 1, tensor(lat))
