"""The port's ensemble Kalman filter (`aesmc_tpu_torch.enkf`) against the
JAX package's.

Draws are replayed from the JAX key schedule: `k_init, k0, key = split(key,
3)`; the initial ensemble's normals from `k_init` (`[B, N, D]`, a
NOT_EXPANDED initial), t = 0's perturbations from `k0`; step t takes
`split(key, T - 1)[t - 1]` = (k_fc, k_an): the forecast's normals, then
the perturbations ('stochastic' only).

Tolerances: means, variances, log-likelihood and ensembles within 1e-4
(float32, relative to the value's scale). ETKF's eigenvectors are not
unique (M has N - Do equal eigenvalues), so the schemes are compared
through their outputs, never through U. The Kalman oracle at N = 1,000:
the JAX test's bars at N = 4,000 (mean RMSE 0.08, variances 0.08, log-Z 5
%) scaled by sqrt(4) for the Monte Carlo error of a quarter of the
members: 0.16, 0.16 and 10 %.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aesmc_tpu import distributions as jax_dists
from aesmc_tpu import enkf as jax_enkf
from aesmc_tpu.state import BatchShapeMode as JaxMode
from aesmc_tpu_torch import distributions as dists
from aesmc_tpu_torch import enkf
from aesmc_tpu_torch.models import kalman_nd, lorenz
from aesmc_tpu_torch.noise import NoiseSource
from aesmc_tpu_torch.state import BatchShapeMode
from torch_replay import ReplayNoise

CPU = torch.device("cpu")
DIM = 4


def _matrices(dim=DIM, seed=0):
    rng = np.random.default_rng(seed)
    a = (0.9 * np.eye(dim) + 0.05 * rng.normal(size=(dim, dim)))
    return a.astype(np.float32), np.eye(dim, dtype=np.float32)


def _components(lib, a):
    """x_0 ~ N(0, I), x_t = A x_{t-1} + N(0, 0.7^2 I) in either package."""
    if lib == "jax":
        def initial():
            return jax_dists.MultivariateNormalDiag(jnp.zeros(DIM),
                                                    jnp.ones(DIM))

        def transition(previous_latents=None, time=None,
                       previous_observations=None):
            x = previous_latents[-1]
            return jax_dists.MultivariateNormalDiag(
                x @ jnp.asarray(a).T, jnp.full(x.shape, 0.7),
                batch_shape_mode=JaxMode.FULLY_EXPANDED)
        return initial, transition
    ta = torch.tensor(a)

    def initial():
        return dists.MultivariateNormalDiag(torch.zeros(DIM), torch.ones(DIM))

    def transition(previous_latents=None, time=None,
                   previous_observations=None):
        x = previous_latents[-1]
        return dists.MultivariateNormalDiag(
            x @ ta.T, torch.full_like(x, 0.7),
            batch_shape_mode=BatchShapeMode.FULLY_EXPANDED)
    return initial, transition


def _simulate(a, c, num_timesteps, batch, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(batch, DIM)
    ys = []
    for _ in range(num_timesteps):
        ys.append(x @ c.T + 0.5 * rng.randn(batch, c.shape[0]))
        x = x @ a.T + 0.7 * rng.randn(batch, DIM)
    return np.asarray(ys, np.float32)


def _draws(key, num_timesteps, batch, n, dim, obs_dim, method):
    k_init, k0, key = jax.random.split(key, 3)
    normals = [np.asarray(jax.random.normal(k_init, (batch, n, dim)))]
    if method == "stochastic":
        normals.append(np.asarray(jax.random.normal(k0, (batch, n, obs_dim))))
    if num_timesteps > 1:
        for k in jax.random.split(key, num_timesteps - 1):
            k_fc, k_an = jax.random.split(k)
            normals.append(np.asarray(jax.random.normal(k_fc,
                                                        (batch, n, dim))))
            if method == "stochastic":
                normals.append(np.asarray(jax.random.normal(
                    k_an, (batch, n, obs_dim))))
    return ReplayNoise(normals=normals)


@pytest.mark.parametrize("method,localized,obs_dim", [
    ("stochastic", False, DIM), ("stochastic", True, DIM),
    ("stochastic", True, 2), ("etkf", False, DIM), ("etkf", False, 2)])
def test_enkf_replays_jax(method, localized, obs_dim):
    T, B, N = 6, 2, 16
    a, c = _matrices()
    c = c[::2] if obs_dim == 2 else c
    obs = _simulate(a, c, T, B, seed=1)
    key = jax.random.PRNGKey(3)
    observed = range(0, DIM, DIM // obs_dim)
    loc = (jax_enkf.gaspari_cohn_localization(DIM, observed, radius=1.0)
           if localized else None)
    kwargs = dict(method=method, inflation=1.05, return_ensembles=True)
    want = jax_enkf.enkf_filter(
        jnp.asarray(obs), *_components("jax", a),
        lambda x: jnp.asarray(c) @ x, 0.25, N, key=key, localization=loc,
        **kwargs)
    port_loc = (enkf.gaspari_cohn_localization(DIM, observed, radius=1.0)
                if localized else None)
    noise = _draws(key, T, B, N, DIM, obs_dim, method)
    got = enkf.enkf_filter(
        torch.tensor(obs), *_components("torch", a),
        lambda x: torch.tensor(c) @ x, 0.25, N, noise=noise,
        localization=port_loc, **kwargs)
    assert noise.exhausted()
    for name in ("filtered_means", "filtered_variances", "log_likelihood",
                 "last_ensemble", "ensembles"):
        w = np.asarray(want[name])
        assert tuple(got[name].shape) == w.shape, name
        np.testing.assert_allclose(got[name].numpy(), w, rtol=1e-4,
                                   atol=1e-4 * max(1.0, np.abs(w).max()),
                                   err_msg=name)


@pytest.mark.parametrize("method", ["stochastic", "etkf"])
def test_matches_exact_kalman(method):
    T, B, N = 12, 2, 1000
    a, c = _matrices()
    obs = _simulate(a, c, T, B, seed=2)
    out = enkf.enkf_filter(
        torch.tensor(obs), *_components("torch", a), lambda x: x, 0.25, N,
        noise=NoiseSource.seeded(0, CPU), method=method)
    params = kalman_nd.KalmanNdParams(
        initial_mean=np.zeros(DIM), initial_cov=np.eye(DIM),
        transition_matrix=a.astype(np.float64),
        transition_cov=0.49 * np.eye(DIM), emission_matrix=np.eye(DIM),
        emission_cov=0.25 * np.eye(DIM))
    for b in range(B):
        m_exact, p_exact, _, _, ll_exact = kalman_nd.kalman_filter_nd(
            obs[:, b].astype(np.float64), params)
        m = out["filtered_means"][:, b].numpy()
        assert np.sqrt(np.mean((m - m_exact) ** 2)) < 0.16, method
        v_exact = np.stack([np.diag(p) for p in p_exact])
        np.testing.assert_allclose(out["filtered_variances"][:, b].numpy(),
                                   v_exact, atol=0.16, err_msg=method)
        ll = float(out["log_likelihood"][b])
        assert abs(ll - ll_exact) < 0.10 * abs(ll_exact), (ll, ll_exact)


def test_etkf_is_deterministic_given_the_forecast():
    """ETKF draws no perturbation: two runs from the same seed coincide, and
    5 steps take 5 normal draws (the initial ensemble and the forecasts),
    against the stochastic scheme's 10."""
    a, c = _matrices()
    obs = torch.tensor(_simulate(a, c, 5, 1, seed=2))

    def run(method, seed=0):
        return enkf.enkf_filter(obs, *_components("torch", a), lambda x: x,
                                0.25, 64, noise=NoiseSource.seeded(seed, CPU),
                                method=method)
    x, y = run("etkf"), run("etkf")
    assert torch.equal(x["filtered_means"], y["filtered_means"])

    class Counting(NoiseSource):
        draws = 0

        def normal(self, shape):
            Counting.draws += 1
            return super().normal(shape)

    for method, want in (("etkf", 5), ("stochastic", 10)):
        Counting.draws = 0
        enkf.enkf_filter(obs, *_components("torch", a), lambda x: x, 0.25, 8,
                         noise=Counting(torch.Generator().manual_seed(0)),
                         method=method)
        assert Counting.draws == want, method


def test_small_localized_ensemble_tracks_lorenz():
    """tests/test_enkf.py's Lorenz-96 bar on the port: N = 20 with
    inflation 1.05 and Gaspari-Cohn localization tracks an 8-dim truth
    observed every other component (RMSE over the second half < 1)."""
    T, N, dim = 25, 20, 8
    obs_idx = tuple(range(0, dim, 2))
    initial, transition, _, _ = lorenz.make_model(
        dim=dim, obs_indices=obs_idx, emission_scale=0.5,
        transition_scale=0.3, proposal="bootstrap", device="cpu")
    gen = torch.Generator().manual_seed(3)
    x = 8.0 + torch.randn(1, dim, generator=gen)
    truth, ys = [], []
    for t in range(T):
        if t:
            x = lorenz.rk4_step(x) + 0.3 * torch.randn(1, dim, generator=gen)
        truth.append(x)
        ys.append(x[:, list(obs_idx)] + 0.5 * torch.randn(
            1, len(obs_idx), generator=gen))
    truth, obs = torch.stack(truth)[:, 0], torch.stack(ys)
    loc = enkf.gaspari_cohn_localization(dim, obs_idx, radius=2.0)
    out = enkf.enkf_filter(obs, initial, transition,
                           lambda v: v[list(obs_idx)], 0.25, N,
                           noise=NoiseSource.seeded(0, CPU), inflation=1.05,
                           localization=loc)
    means = out["filtered_means"][:, 0]
    rmse = float(torch.sqrt(torch.mean((means[T // 2:] - truth[T // 2:])
                                       ** 2)))
    assert rmse < 1.0, rmse
    assert bool(torch.isfinite(out["log_likelihood"]).all())


def test_gaspari_cohn_helpers_match_jax():
    """The tapers in [0, 1]: the port's float64 helpers within float32's
    rounding (1e-6) of the JAX package's float32 ones."""
    d = np.linspace(0.0, 5.0, 51)
    np.testing.assert_allclose(enkf.gaspari_cohn(d, 2.0).numpy(),
                               np.asarray(jax_enkf.gaspari_cohn(d, 2.0)),
                               rtol=0, atol=1e-6)
    assert float(enkf.gaspari_cohn(0.0, 2.0)) == 1.0
    assert float(enkf.gaspari_cohn(4.0, 2.0)) == 0.0
    assert float(enkf.gaspari_cohn(5.0, 2.0)) == 0.0
    assert 0.0 < float(enkf.gaspari_cohn(2.0, 2.0)) < 0.5
    got = enkf.gaspari_cohn_localization(8, range(0, 8, 2), radius=1.0)
    want = jax_enkf.gaspari_cohn_localization(8, range(0, 8, 2), radius=1.0)
    for g, w in zip(got, want):
        assert tuple(g.shape) == np.asarray(w).shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-6)
    assert float(got[0][7, 0]) > 0.0


def test_validation_errors():
    a, c = _matrices()
    obs = torch.tensor(_simulate(a, c, 3, 1, seed=0))
    comps = _components("torch", a)
    with pytest.raises(ValueError, match="method must be one of"):
        enkf.enkf_filter(obs, *comps, lambda x: x, 0.25, 8, method="letkf")
    with pytest.raises(ValueError, match="localization is only supported"):
        enkf.enkf_filter(obs, *comps, lambda x: x, 0.25, 8, method="etkf",
                         localization=enkf.gaspari_cohn_localization(DIM))
    with pytest.raises(ValueError, match="num_members must be >= 2"):
        enkf.enkf_filter(obs, *comps, lambda x: x, 0.25, 1)
    with pytest.raises(ValueError, match="expects array observations"):
        enkf.enkf_filter(obs[..., 0], *comps, lambda x: x, 0.25, 8)


@pytest.mark.parametrize("obs_cov", [0.25, "diag", "full"])
def test_observation_covariance_forms(obs_cov):
    """A number, a diagonal and a full matrix give the same R."""
    a, c = _matrices()
    obs = torch.tensor(_simulate(a, c, 3, 2, seed=0))
    cov = {"diag": torch.full((DIM,), 0.25),
           "full": 0.25 * torch.eye(DIM)}.get(obs_cov, obs_cov)
    out = enkf.enkf_filter(obs, *_components("torch", a), lambda x: x, cov, 8,
                           noise=NoiseSource.seeded(1, CPU))
    ref = enkf.enkf_filter(obs, *_components("torch", a), lambda x: x, 0.25,
                           8, noise=NoiseSource.seeded(1, CPU))
    torch.testing.assert_close(out["log_likelihood"], ref["log_likelihood"])
