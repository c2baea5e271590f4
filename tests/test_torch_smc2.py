"""The port's SMC^2 (`aesmc_tpu_torch.smc2`) against the JAX package's.

`build_components` builds the LGSSM the JAX way,
`lgssm.Transition(mult=theta["mult"], scale=1.0)`: the JAX package vmaps
it over theta, the port calls it once with `[M B, 1]` leaves. Draws are
replayed from the JAX key schedule: `key, k0 = split(key)`, the inner
t = 0 proposal draws from `split(k0, M)[m]` (theta m's rows of the port's
one `[M B, K]` draw), then `split(split(key)[1], T - 1)[t - 1]` a step:
`k_adv, k_rej = split(.)`, the inner systematic uniforms `[M B, 1]` and
the proposal draws `split(k_prop, M)[m]` from `k_res, k_prop =
split(k_adv)`; on a rejuvenation (where the JAX run's ESS fell below the
threshold) the theta-resampling uniform from `k_res` and per move
`k_noise, k_run, k_acc = split(kk, 3)`: the random-walk normals, the
rerun's draws up to the current step (`split(k_run, M + 1)`) and the
accept uniforms. The JAX package's CDF is patched in. (T, B, M, K) =
(6, 2, 8, 32).

Tolerances: rejuvenation counts equal; thetas, weights, evidences, ESS
paths and acceptance within 1e-5 relative (float32 sums in another
order). The Kalman-grid oracle of tests/test_smc2.py (posterior mean,
std ratio in (0.5, 2), log evidence within 2) on the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats as sps

from aesmc_tpu import resampling as jax_resampling
from aesmc_tpu import smc2 as jax_smc2
from aesmc_tpu import statistics as jax_statistics
from aesmc_tpu.models import lgssm as jax_lgssm
from aesmc_tpu_torch import resampling, smc2
from aesmc_tpu_torch.models import kalman, lgssm
from aesmc_tpu_torch.noise import NoiseSource
from torch_replay import (IslandOnlyMesh, PlainSystematic, ReplayNoise,
                          normal_draw, tensor)

T, B, M, K = 6, 2, 8, 32
KEY = jax.random.PRNGKey(9)
CPU = torch.device("cpu")
EMISSION_SCALE = 0.5


def _problem(lib, true_mult=0.8):
    mod = jax_lgssm if lib == "jax" else lgssm
    sig = float(np.sqrt(1.0 / (1.0 + 1.0 / EMISSION_SCALE ** 2)))
    if lib == "jax":
        emission = jax_lgssm.Emission.create(1.0, EMISSION_SCALE)
        proposal = jax_lgssm.Proposal(
            lin_0_weight=jnp.asarray(0.8), lin_0_bias=jnp.asarray(0.0),
            lin_t_weight=jnp.asarray([0.2 * true_mult, 0.8]),
            lin_t_bias=jnp.asarray(0.0), scale_0=sig, scale_t=sig)
    else:
        emission = lgssm.Emission(1.0, EMISSION_SCALE)
        proposal = lgssm.Proposal(0.8, 0.0, [0.2 * true_mult, 0.8], 0.0,
                                  sig, sig)
    initial = mod.Initial(0.0, 1.0)

    def build(theta):
        return (initial, mod.Transition(mult=theta["mult"], scale=1.0),
                emission, proposal)

    def log_prior(theta):
        return -0.5 * theta["mult"] ** 2

    return build, log_prior


def _obs(num_timesteps, batch, seed=11):
    _, y = jax_statistics.sample_from_prior(
        jax_lgssm.Initial(0.0, 1.0), jax_lgssm.Transition.create(0.8, 1.0),
        jax_lgssm.Emission.create(1.0, EMISSION_SCALE), num_timesteps, batch,
        jax.random.PRNGKey(seed))
    return np.asarray(y)


@pytest.fixture
def jax_cdf(monkeypatch):
    monkeypatch.setattr(resampling, "_normalized_cumsum", lambda lw: tensor(
        jax_resampling._normalized_cumsum(jnp.asarray(lw.detach().numpy()))))


class _Draws:
    def __init__(self, num_theta, batch):
        self.m, self.b = num_theta, batch
        self.draws = {"uniforms": [], "normals": []}

    def init(self, key):
        self.draws["normals"].append(np.concatenate([
            normal_draw(k, (K,), (self.b,), True)
            for k in jax.random.split(key, self.m)]))

    def advance(self, key):
        k_res, k_prop = jax.random.split(key)
        self.draws["uniforms"].append(np.asarray(
            jax.random.uniform(k_res, (self.m * self.b, 1))))
        self.draws["normals"].append(np.concatenate([
            normal_draw(k, (self.b, K))
            for k in jax.random.split(k_prop, self.m)]))

    def rejuvenate(self, key, t_now, num_moves, num_timesteps):
        k_res, k_moves = jax.random.split(key)
        self.draws["uniforms"].append(np.asarray(jax.random.uniform(
            k_res, (1, 1))))
        for kk in jax.random.split(k_moves, num_moves):
            k_noise, k_run, k_acc = jax.random.split(kk, 3)
            self.draws["normals"].append(np.asarray(jax.random.normal(
                jax.random.split(k_noise, 1)[0], (self.m,))))
            init_keys = jax.random.split(k_run, self.m + 1)
            self.draws["normals"].append(np.concatenate([
                normal_draw(k, (K,), (self.b,), True)
                for k in init_keys[1:]]))
            step_keys = jax.random.split(init_keys[0], num_timesteps - 1)
            for t in range(1, t_now + 1):
                self.advance(step_keys[t - 1])
            self.draws["uniforms"].append(np.asarray(jax.random.uniform(
                k_acc, (self.m,))))


def _replay(key, want, num_timesteps, batch, num_theta, threshold,
            num_moves):
    draws = _Draws(num_theta, batch)
    key, k0 = jax.random.split(key)
    draws.init(k0)
    _, ks = jax.random.split(key)
    ess = np.asarray(want["ess_path"])
    for t, kk in enumerate(jax.random.split(ks, num_timesteps - 1), 1):
        k_adv, k_rej = jax.random.split(kk)
        draws.advance(k_adv)
        if ess[t] < threshold * num_theta:
            draws.rejuvenate(k_rej, t, num_moves, num_timesteps)
    return ReplayNoise(**draws.draws)


@pytest.mark.parametrize("threshold,num_moves", [(0.8, 2), (0.0, 2),
                                                 (0.95, 1)])
def test_smc2_replays_jax(jax_cdf, threshold, num_moves):
    obs = _obs(T, B)
    theta0 = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (M,)))
    kwargs = dict(ess_threshold=threshold, num_moves=num_moves,
                  step_size=0.2, return_history=True)
    jax_build, jax_log_prior = _problem("jax")
    want = jax_smc2.smc2(obs, jax_build, {"mult": theta0}, jax_log_prior,
                         num_particles=K, key=KEY, **kwargs)
    noise = _replay(KEY, want, T, B, M, threshold, num_moves)
    build, log_prior = _problem("torch")
    with torch.no_grad():
        got = smc2.smc2(tensor(obs), build, {"mult": tensor(theta0)},
                        log_prior, num_particles=K, noise=noise, **kwargs)
    assert noise.exhausted()
    assert int(got["num_rejuvenations"]) == int(want["num_rejuvenations"])
    if threshold == 0.0:
        assert int(got["num_rejuvenations"]) == 0
        np.testing.assert_array_equal(got["theta"]["mult"].numpy(), theta0)
    else:
        assert int(got["num_rejuvenations"]) >= 1
    for name in ("log_theta_weight", "log_evidence",
                 "inner_log_marginal_likelihood", "acceptance_rate",
                 "ess_path", "log_theta_weight_history"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   rtol=1e-5, atol=1e-5)
    for name in ("theta", "theta_history"):
        np.testing.assert_allclose(got[name]["mult"].numpy(),
                                   np.asarray(want[name]["mult"]),
                                   rtol=1e-5, atol=1e-6)


def _exact_grid_posterior(obs, lo=-2.5, hi=2.5, n=501):
    grid = np.linspace(lo, hi, n)
    log_lik = np.array([sum(kalman.kalman_filter(
        obs[:, b].astype(np.float64), kalman.KalmanParams(
            0.0, 1.0, float(g), 0.0, 1.0, 1.0, 0.0,
            EMISSION_SCALE ** 2))[4] for b in range(obs.shape[1]))
        for g in grid])
    log_joint = log_lik + sps.norm.logpdf(grid)
    mx = log_joint.max()
    log_evidence = mx + np.log(np.trapezoid(np.exp(log_joint - mx),
                                            dx=grid[1] - grid[0]))
    w = np.exp(log_joint - mx)
    w /= w.sum()
    mean = float((grid * w).sum())
    return mean, float(np.sqrt(((grid - mean) ** 2 * w).sum())), \
        float(log_evidence)


def test_theta_posterior_and_evidence_match_kalman_grid():
    """tests/test_smc2.py's oracle: T = 25, M = 384, K = 64."""
    obs = _obs(25, 1)
    num_theta = 384
    theta0 = tensor(jax.random.normal(jax.random.PRNGKey(3), (num_theta,)))
    build, log_prior = _problem("torch")
    with torch.no_grad():
        out = smc2.smc2(tensor(obs), build, {"mult": theta0}, log_prior,
                        num_particles=64, noise=NoiseSource.seeded(7, CPU),
                        ess_threshold=0.5, num_moves=2, step_size=0.2)
    exact_mean, exact_std, exact_lz = _exact_grid_posterior(obs)
    w = torch.softmax(out["log_theta_weight"], dim=0).numpy()
    vals = out["theta"]["mult"].numpy()
    mean = float((vals * w).sum())
    std = float(np.sqrt(((vals - mean) ** 2 * w).sum()))
    assert abs(mean - exact_mean) < max(3 * exact_std / np.sqrt(num_theta),
                                        0.05), (mean, exact_mean)
    assert 0.5 < std / exact_std < 2.0, (std, exact_std)
    assert abs(float(out["log_evidence"]) - exact_lz) < 2.0
    assert int(out["num_rejuvenations"]) >= 1
    assert float(out["acceptance_rate"]) > 0.02


def test_shapes_and_one_step():
    build, log_prior = _problem("torch")
    obs = _obs(7, 2)
    theta0 = {"mult": torch.randn(16, generator=torch.Generator()
                                  .manual_seed(0))}
    with torch.no_grad():
        out = smc2.smc2(tensor(obs), build, theta0, log_prior,
                        num_particles=8, noise=NoiseSource.seeded(0, CPU),
                        return_history=True)
        one = smc2.smc2(tensor(obs[:1]), build, theta0, log_prior,
                        num_particles=8, noise=NoiseSource.seeded(0, CPU))
    assert out["theta"]["mult"].shape == (16,)
    assert out["inner_log_marginal_likelihood"].shape == (16, 2)
    assert out["ess_path"].shape == (7,)
    assert out["theta_history"]["mult"].shape == (7, 16)
    assert out["log_theta_weight_history"].shape == (7, 16)
    ess = out["ess_path"].numpy()
    assert np.all(ess >= 1.0 - 1e-4) and np.all(ess <= 16 + 1e-4)
    assert one["ess_path"].shape == (1,)
    assert torch.isfinite(one["log_evidence"])


def test_validation_errors():
    build, log_prior = _problem("torch")
    obs = tensor(_obs(3, 1))
    with pytest.raises(ValueError, match="num_theta"):
        smc2.smc2(obs, build, {"mult": torch.zeros(1)}, log_prior, 4)
    with pytest.raises(ValueError, match="ess_threshold"):
        smc2.smc2(obs, build, {"mult": torch.zeros(4)}, log_prior, 4,
                  ess_threshold=1.5)
    with pytest.raises(ValueError, match="particle_axis"):
        smc2.smc2(obs, build, {"mult": torch.zeros(4)}, log_prior, 4,
                  mesh=IslandOnlyMesh())
    # A plain callable resamples the inner rows: the default route's bits.
    plain = PlainSystematic()
    theta0 = {"mult": torch.linspace(0.5, 1.0, 4)}
    got = smc2.smc2(obs, build, theta0, log_prior, 4,
                    noise=NoiseSource.seeded(0, "cpu"),
                    resampling_implementation=plain)
    want = smc2.smc2(obs, build, theta0, log_prior, 4,
                     noise=NoiseSource.seeded(0, "cpu"))
    assert plain.calls >= 2
    for name in ("log_evidence", "inner_log_marginal_likelihood"):
        torch.testing.assert_close(got[name], want[name], rtol=0, atol=0)
