"""The port's IF2 (`aesmc_tpu_torch.if2`) against the JAX package's.

`build_components` builds the LGSSM the JAX way,
`lgssm.Transition(mult=theta["mult"], scale=1.0)` with `[B, K]` tensor
leaves (the components keep a tensor as given). Draws are replayed from
the JAX key schedule `split(key, (M, T, 3))[m, t]` = (resample, propose,
perturb): per iteration the t = 0 re-dispersal's normals (one `[B, K]`
draw a leaf from `split(keys[0, 2], L)`, sorted keys), the t = 0
proposal's, then per step the systematic uniforms, the perturbation
normals and the proposal's normals, and the final draw's uniforms from
`keys[0, 0]`; the JAX package's CDF is patched in so that the ancestors
compare exactly. (T, B, K) = (10, 2, 64), 3 iterations.

Tolerances: theta swarms, their means and the per-iteration log-Z within
1e-5 relative (float32 sums in another order, and the cooling factor
cooling**m taken in float64 here, in float32 there). The MLE oracle of
tests/test_if2.py (every row within 0.08 of the Kalman-grid MLE) on the
port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aesmc_tpu import if2 as jax_if2
from aesmc_tpu import resampling as jax_resampling
from aesmc_tpu import statistics as jax_statistics
from aesmc_tpu.models import lgssm as jax_lgssm
from aesmc_tpu_torch import if2, resampling
from aesmc_tpu_torch.models import kalman, lgssm
from aesmc_tpu_torch.noise import NoiseSource
from torch_replay import PlainSystematic, ReplayNoise, tensor

T, B, K, M = 10, 2, 64, 3
KEY = jax.random.PRNGKey(31)
CPU = torch.device("cpu")


class Bootstrap:
    def __init__(self, initial, transition):
        self.i, self.t = initial, transition

    def __call__(self, previous_latents=None, time=None, observations=None):
        if time == 0:
            return self.i()
        return self.t(previous_latents=previous_latents, time=time)


def _build(lib, learn_emission=False):
    mod = jax_lgssm if lib == "jax" else lgssm
    initial = mod.Initial(0.0, 1.0)
    fixed_emission = (jax_lgssm.Emission.create(1.0, 0.5) if lib == "jax"
                      else lgssm.Emission(1.0, 0.5))

    def build(theta):
        tr = mod.Transition(mult=theta["mult"], scale=1.0)
        em = (mod.Emission(mult=theta["em"], scale=0.5) if learn_emission
              else fixed_emission)
        return initial, tr, em, Bootstrap(initial, tr)

    return build


def _obs(num_timesteps, batch, seed=1):
    _, y = jax_statistics.sample_from_prior(
        jax_lgssm.Initial(0.0, 1.0), jax_lgssm.Transition.create(0.8, 1.0),
        jax_lgssm.Emission.create(1.0, 0.5), num_timesteps, batch,
        jax.random.PRNGKey(seed))
    return np.asarray(y)


@pytest.fixture
def jax_cdf(monkeypatch):
    monkeypatch.setattr(resampling, "_normalized_cumsum", lambda lw: tensor(
        jax_resampling._normalized_cumsum(jnp.asarray(lw.detach().numpy()))))


def _replay(key, num_timesteps, num_iterations, num_leaves):
    all_keys = jax.random.split(key, (num_iterations, num_timesteps, 3))
    draws = {"uniforms": [], "normals": []}

    def perturb(k):
        for kk in jax.random.split(k, num_leaves):
            draws["normals"].append(np.asarray(jax.random.normal(kk, (B, K))))

    for m in range(num_iterations):
        keys = all_keys[m]
        perturb(keys[0, 2])
        draws["normals"].append(np.asarray(jax.random.normal(keys[0, 1],
                                                             (B, K))))
        for t in range(1, num_timesteps):
            draws["uniforms"].append(np.asarray(jax.random.uniform(
                keys[t, 0], (B, 1))))
            perturb(keys[t, 2])
            draws["normals"].append(np.asarray(jax.random.normal(
                keys[t, 1], (B, K))))
        draws["uniforms"].append(np.asarray(jax.random.uniform(keys[0, 0],
                                                               (B, 1))))
    return ReplayNoise(**draws)


@pytest.mark.parametrize("theta0,rw,learn_emission", [
    ({"mult": 0.5}, {"mult": 0.1}, False),
    ({"mult": np.asarray([0.3, 0.6], np.float32)}, {"mult": 0.1}, False),
    ({"mult": 0.5, "em": 0.7}, {"mult": 0.1, "em": 0.05}, True)])
def test_if2_replays_jax(jax_cdf, theta0, rw, learn_emission):
    obs = _obs(T, B)
    want = jax_if2.if2(obs, _build("jax", learn_emission), theta0, rw,
                       num_particles=K, num_iterations=M, key=KEY,
                       cooling=0.8)
    noise = _replay(KEY, T, M, len(theta0))
    with torch.no_grad():
        got = if2.if2(tensor(obs), _build("torch", learn_emission),
                      {k: (tensor(v) if isinstance(v, np.ndarray) else v)
                       for k, v in theta0.items()}, rw, num_particles=K,
                      num_iterations=M, noise=noise, cooling=0.8)
    assert noise.exhausted()
    for name in theta0:
        assert got["theta"][name].shape == (B, K)
        assert got["theta_trajectory"][name].shape == (M, B)
        for key in ("theta", "theta_mean", "theta_trajectory"):
            np.testing.assert_allclose(got[key][name].numpy(),
                                       np.asarray(want[key][name]),
                                       rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["log_likelihoods"].numpy(),
                               np.asarray(want["log_likelihoods"]),
                               rtol=1e-5)


def _exact_mle(obs, b):
    grid = np.linspace(0.5, 1.1, 121)
    lls = [kalman.kalman_filter(
        obs[:, b].astype(np.float64),
        kalman.KalmanParams(0.0, 1.0, g, 0.0, 1.0, 1.0, 0.0, 0.25))[4]
        for g in grid]
    return grid[int(np.argmax(lls))]


def test_recovers_per_row_mle():
    """tests/test_if2.py's oracle: T = 50, B = 2, K = 256, 40 iterations at
    cooling 0.9; each row's estimate within 0.08 of its Kalman-grid MLE,
    and the log-likelihood trend rises."""
    obs = _obs(50, 2)
    mle = np.array([_exact_mle(obs, b) for b in range(2)])
    with torch.no_grad():
        out = if2.if2(tensor(obs), _build("torch"), {"mult": 0.3},
                      {"mult": 0.1}, num_particles=256, num_iterations=40,
                      noise=NoiseSource.seeded(0, CPU), cooling=0.9)
    est = out["theta_mean"]["mult"].numpy()
    assert np.abs(est - mle).max() < 0.08, (est, mle)
    lls = out["log_likelihoods"].numpy()
    assert (lls[-3:].mean(axis=0) > lls[:3].mean(axis=0)).all()


def test_tensor_theta_keeps_its_graph():
    """A theta0 leaf that requires grad reaches the components as given:
    the log-likelihoods differentiate back to it."""
    obs = _obs(4, B)
    theta0 = torch.full((B,), 0.6, requires_grad=True)
    out = if2.if2(tensor(obs), _build("torch"), {"mult": theta0},
                  {"mult": 0.0}, num_particles=16, num_iterations=1,
                  noise=NoiseSource.seeded(1, CPU))
    out["log_likelihoods"].sum().backward()
    assert theta0.grad is not None and torch.isfinite(theta0.grad).all()


def test_bad_theta0_shape_raises():
    with pytest.raises(ValueError, match="theta0 leaves"):
        if2.if2(tensor(_obs(5, B)), _build("torch"),
                {"mult": torch.zeros(3)}, {"mult": 0.1}, num_particles=16,
                num_iterations=2, noise=NoiseSource.seeded(0, CPU))
    # A plain callable moves the latent and theta together: the default
    # route's bits.
    plain = PlainSystematic()
    kwargs = dict(num_particles=16, num_iterations=2)
    got = if2.if2(tensor(_obs(5, B)), _build("torch"), {"mult": 0.5},
                  {"mult": 0.1}, noise=NoiseSource.seeded(0, CPU),
                  resampling_implementation=plain, **kwargs)
    want = if2.if2(tensor(_obs(5, B)), _build("torch"), {"mult": 0.5},
                   {"mult": 0.1}, noise=NoiseSource.seeded(0, CPU), **kwargs)
    assert plain.calls == 2 * 5
    for name in ("log_likelihoods", "theta_mean"):
        torch.testing.assert_close(got[name], want[name], rtol=0, atol=0)


def test_single_timestep():
    with torch.no_grad():
        out = if2.if2(tensor(_obs(1, B)), _build("torch"), {"mult": 0.5},
                      {"mult": 0.1}, num_particles=16, num_iterations=3,
                      noise=NoiseSource.seeded(0, CPU))
    assert out["log_likelihoods"].shape == (3, B)
    assert torch.isfinite(out["log_likelihoods"]).all()
