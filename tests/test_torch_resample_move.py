"""The port's resample-move filter (`aesmc_tpu_torch.resample_move`) against
the JAX package's.

Draws are replayed from the JAX key schedule `split(key, (T, 3))[t]`:
stream 0 resamples, stream 1 moves (per move `key, k_prop, k_acc =
split(key, 3)`: a normal like the head from `split(k_prop, 1)[0]`, then
`[B, K]` uniforms with minval 1e-38 from `k_acc`), stream 2 proposes; the
JAX package's CDF is patched in so that the ancestors compare exactly. The
LGSSM x' = 0.9 x + N(0, 1), y = x + N(0, 0.5^2) at (T, B, K) = (8, 2, 64),
with the bootstrap and the optimal proposal.

Tolerances: acceptance rates within 1e-6 relative (means of the same
accept decisions, summed in another order); latents, log-weights and
log-Z within 1e-5 relative (float32 sums in another order). The Kalman oracle of tests/test_resample_move.py (mean
log-Z over 6 seeds within 0.6 of the exact value a row) on the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aesmc_tpu import resample_move as jax_rm
from aesmc_tpu import resampling as jax_resampling
from aesmc_tpu import statistics as jax_statistics
from aesmc_tpu.models import lgssm as jax_lgssm
from aesmc_tpu_torch import resample_move, resampling
from aesmc_tpu_torch.models import kalman, lgssm
from aesmc_tpu_torch.noise import NoiseSource
from torch_replay import ReplayNoise, normal_draw, tensor

A, Q, EM, R0 = 0.9, 1.0, 1.0, 0.25
T, B, K = 8, 2, 64
KEY = jax.random.PRNGKey(21)
CPU = torch.device("cpu")


class Bootstrap:
    """Propose from the transition (the prior at t = 0)."""

    def __init__(self, initial, transition):
        self.initial, self.transition = initial, transition

    def __call__(self, previous_latents=None, time=None, observations=None):
        if time == 0:
            return self.initial()
        return self.transition(previous_latents=previous_latents, time=time)


def _optimal(lib):
    prec_t = 1.0 / Q + EM ** 2 / R0
    prec_0 = 1.0 + EM ** 2 / R0
    args = ((EM / R0) / prec_0, 0.0, [(A / Q) / prec_t, (EM / R0) / prec_t],
            0.0, float(np.sqrt(1.0 / prec_0)), float(np.sqrt(1.0 / prec_t)))
    if lib == "jax":
        return jax_lgssm.Proposal(
            lin_0_weight=jnp.asarray(args[0]), lin_0_bias=jnp.asarray(0.0),
            lin_t_weight=jnp.asarray(args[2]), lin_t_bias=jnp.asarray(0.0),
            scale_0=args[4], scale_t=args[5])
    return lgssm.Proposal(*args)


def _components(lib, proposal):
    if lib == "jax":
        comps = (jax_lgssm.Initial(0.0, 1.0),
                 jax_lgssm.Transition.create(A, np.sqrt(Q)),
                 jax_lgssm.Emission.create(EM, np.sqrt(R0)))
    else:
        comps = (lgssm.Initial(0.0, 1.0), lgssm.Transition(A, np.sqrt(Q)),
                 lgssm.Emission(EM, np.sqrt(R0)))
    prop = (Bootstrap(*comps[:2]) if proposal == "bootstrap"
            else _optimal(lib))
    return comps + (prop,)


@pytest.fixture(scope="module")
def obs():
    _, y = jax_statistics.sample_from_prior(
        *_components("jax", "bootstrap")[:3], T, B, jax.random.PRNGKey(11))
    return np.asarray(y)


@pytest.fixture
def jax_cdf(monkeypatch):
    monkeypatch.setattr(resampling, "_normalized_cumsum", lambda lw: tensor(
        jax_resampling._normalized_cumsum(jnp.asarray(lw.detach().numpy()))))


def _replay(key, num_timesteps, moves, proposal, method="systematic"):
    keys = jax.random.split(key, (num_timesteps, 3))
    first = (normal_draw(keys[0, 2], (B, K)) if proposal == "bootstrap"
             else normal_draw(keys[0, 2], (K,), (B,), True))
    draws = {"uniforms": [], "normals": [first], "exponentials": []}
    for t in range(1, num_timesteps):
        if method == "multinomial":
            draws["exponentials"].append(np.asarray(
                jax.random.exponential(keys[t, 0], (B, K + 1))))
        else:
            shape = (B, 1) if method == "systematic" else (B, K)
            draws["uniforms"].append(np.asarray(
                jax.random.uniform(keys[t, 0], shape)))
        mk = keys[t, 1]
        for _ in range(moves):
            mk, k_prop, k_acc = jax.random.split(mk, 3)
            draws["normals"].append(np.asarray(jax.random.normal(
                jax.random.split(k_prop, 1)[0], (B, K))))
            draws["uniforms"].append(np.asarray(jax.random.uniform(
                k_acc, (B, K), minval=1e-38)))
        draws["normals"].append(normal_draw(keys[t, 2], (B, K)))
    return ReplayNoise(**draws)


@pytest.mark.parametrize("proposal,moves,method,target", [
    ("bootstrap", 2, "systematic", None),
    ("bootstrap", 3, "multinomial", None),
    ("optimal", 2, "stratified", None),
    ("bootstrap", 2, "systematic", 0.234),
    ("optimal", 0, "systematic", None)])
def test_filter_replays_jax(obs, jax_cdf, proposal, moves, method, target):
    kwargs = dict(num_move_steps=moves, resampling_method=method,
                  target_acceptance=target)
    want = jax_rm.resample_move_filter(obs, *_components("jax", proposal),
                                       K, key=KEY, **kwargs)
    noise = _replay(KEY, T, moves, proposal, method)
    got = resample_move.resample_move_filter(
        tensor(obs), *_components("torch", proposal), K, noise=noise,
        **kwargs)
    assert noise.exhausted()
    np.testing.assert_allclose(got["acceptance_rate"].numpy(),
                               np.asarray(want["acceptance_rate"]), rtol=1e-6)
    for name in ("latents", "log_weight", "log_marginal_likelihood"):
        np.testing.assert_allclose(got[name].detach().numpy(),
                                   np.asarray(want[name]), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("num_timesteps", [1, 2])
def test_short_sequences_replay_jax(obs, jax_cdf, num_timesteps):
    y = obs[:num_timesteps]
    want = jax_rm.resample_move_filter(y, *_components("jax", "optimal"),
                                       K, key=KEY)
    noise = _replay(KEY, num_timesteps, 2, "optimal")
    got = resample_move.resample_move_filter(
        tensor(y), *_components("torch", "optimal"), K, noise=noise)
    assert noise.exhausted()
    assert got["latents"].shape == (num_timesteps, B, K)
    assert got["acceptance_rate"].shape == (num_timesteps - 1, B)
    np.testing.assert_allclose(
        got["log_marginal_likelihood"].detach().numpy(),
        np.asarray(want["log_marginal_likelihood"]), rtol=1e-5)


def test_log_z_against_kalman():
    """tests/test_resample_move.py's oracle: T = 30, K = 512, bootstrap,
    3 moves, the mean log-Z over 6 seeds within 0.6 of the exact value."""
    num_timesteps = 30
    _, y = jax_statistics.sample_from_prior(
        *_components("jax", "bootstrap")[:3], num_timesteps, B,
        jax.random.PRNGKey(11))
    y = np.asarray(y)
    comps = _components("torch", "bootstrap")
    lzs = [resample_move.resample_move_filter(
        tensor(y), *comps, 512, noise=NoiseSource.seeded(100 + i, CPU),
        num_move_steps=3, move_scale=0.5,
        return_latents=False)["log_marginal_likelihood"].detach().numpy()
        for i in range(6)]
    lz = np.mean(lzs, axis=0)
    params = kalman.KalmanParams(0.0, 1.0, A, 0.0, Q, EM, 0.0, R0)
    for b in range(B):
        exact = kalman.kalman_filter(y[:, b].astype(np.float64), params)[-1]
        assert abs(lz[b] - exact) < 0.6, (b, lz[b], exact)


def test_acceptance_in_range(obs):
    out = resample_move.resample_move_filter(
        tensor(obs), *_components("torch", "bootstrap"), 32,
        noise=NoiseSource.seeded(8, CPU), num_move_steps=3)
    rate = out["acceptance_rate"].numpy()
    assert rate.shape == (T - 1, B)
    assert 0.05 < rate.mean() < 0.95, rate.mean()


def test_validation(obs):
    comps = _components("torch", "optimal")
    with pytest.raises(ValueError, match="num_move_steps"):
        resample_move.resample_move_filter(tensor(obs), *comps, 8,
                                           num_move_steps=-1)
    with pytest.raises(NotImplementedError, match="slice E"):
        resample_move.resample_move_filter(
            tensor(obs), *comps, 8,
            resampling_implementation=lambda *a: None)
