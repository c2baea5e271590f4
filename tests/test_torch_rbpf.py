"""The port's Rao-Blackwellised particle filter (`aesmc_tpu_torch.rbpf`)
against the JAX package's, and its two exact oracles.

The draws replay the JAX key schedule (`key, k0 = split(key)`, then
`key, k_res, k_prop = split(key, 3)` a step): the regimes' Gumbel noise
and the resampling uniforms. On the 2-regime switching LGSSM (D = 2) at
(T, B, K) = (8, 3, 64), Do = 1 and 4 (the Schur solve), adaptive at ESS
frac 0.5: regimes exactly equal, log-Z within 1e-5 relative, filtered
means within 1e-5 absolute. `_psd_inverse_small` within 1e-6 absolute of
numpy's float64 inverse (log-det within 5e-6) for Do = 1..9 on
well-conditioned matrices. With u-independent linear parameters the
log-evidence equals the exact Kalman filter's within 1e-5 relative for
any K (`tests/test_rbpf.py`'s oracle; the JAX test allows 1e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aesmc_tpu import distributions as jax_dists
from aesmc_tpu import math as jax_math
from aesmc_tpu import rbpf as jax_rbpf
from aesmc_tpu_torch import distributions, rbpf, resampling, state
from aesmc_tpu_torch import math as amath
from aesmc_tpu_torch.models import kalman_nd
from aesmc_tpu_torch.noise import NoiseSource
from aesmc_tpu_torch.ops import resample_cuda, searchsorted_sorted_cuda
from torch_replay import (IslandOnlyMesh, PlainSystematic, ReplayNoise,
                          tensor)

T, B, K, D = 8, 3, 64, 2
KEY = jax.random.PRNGKey(4)
_PI0 = np.log([0.6, 0.4])
_PMAT = np.log([[0.85, 0.15], [0.3, 0.7]])
_A_BY_REGIME = np.array([0.95, 0.2])
_A = np.array([[1.0, 0.1], [0.0, 1.0]])
_C = {1: np.array([[1.0, 0.5]]),
      4: np.array([[1.0, 0.5], [0.3, 1.0], [0.0, 0.8], [0.6, 0.1]])}
_R = {1: np.array([[0.09]]), 4: 0.09 * np.eye(4) + 0.01 * np.ones((4, 4))}


def _switching(lib, do):
    """The bench's switching model (`benchmarks/bench_extended.py:94-131,
    337-369`) for either package."""
    if lib == "jax":
        d, m = jax_dists, jax_math

        def f(x):
            return jnp.asarray(np.asarray(x, np.float32))
    else:
        d, m = distributions, amath

        def f(x):
            return torch.tensor(np.asarray(x, np.float32))

    return dict(
        initial=lambda: d.Categorical(logits=f(_PI0)),
        transition=lambda previous_latents, time: d.Categorical(
            logits=m.table_lookup(f(_PMAT), previous_latents[0])),
        linear_initial=lambda u0: (f(np.zeros(D)), f(np.eye(D))),
        linear_dynamics=lambda u, time: (
            m.table_lookup(f(_A_BY_REGIME), u)[..., None, None] * f(_A),
            f(np.zeros(D)), f(0.5 * np.eye(D))),
        linear_emission=lambda u, time: (f(_C[do]), f(np.zeros(do)),
                                         f(_R[do])))


def _draws(key, method):
    key, k0 = jax.random.split(key)
    gumbels = [np.asarray(jax.random.gumbel(k0, (B, K, 2)))]
    uniforms = []
    for _ in range(1, T):
        key, k_res, k_prop = jax.random.split(key, 3)
        uniforms.append(np.asarray(jax.random.uniform(
            k_res, (B, 1) if method == "systematic" else (B, K))))
        gumbels.append(np.asarray(jax.random.gumbel(k_prop, (B, K, 2))))
    return ReplayNoise(uniforms=uniforms, gumbels=gumbels)


_OPTIONS = dict(num_particles=K, ess_threshold=0.5, return_history=True)


@pytest.fixture(scope="module")
def reference():
    """The JAX filter, once a (Do, method): (observations, output)."""
    out = {}
    for do in (1, 4):
        obs = np.asarray(jax.random.normal(jax.random.PRNGKey(do),
                                           (T, B, do)))
        for method in ("systematic", "stratified"):
            # One jitted program compiles faster than the scan op by op.
            run = jax.jit(lambda o, k, do=do, method=method: jax_rbpf.rbpf(
                o, key=k, resampling_method=method, **_OPTIONS,
                **_switching("jax", do)))
            out[do, method] = (obs, run(jnp.asarray(obs), KEY))
    return out


def _port(reference, do, method):
    obs, _ = reference[do, method]
    noise = _draws(KEY, method)
    out = rbpf.rbpf(tensor(obs), noise=noise, resampling_method=method,
                    **_OPTIONS, **_switching("torch", do))
    assert noise.exhausted()
    return out


@pytest.mark.parametrize("do", [1, 4])
@pytest.mark.parametrize("method", ["systematic", "stratified"])
def test_rbpf_matches_jax(do, method, reference):
    _, want = reference[do, method]
    out = _port(reference, do, method)
    np.testing.assert_array_equal(out["nonlinear_latents"].numpy(),
                                  np.asarray(want["nonlinear_latents"]))
    np.testing.assert_array_equal(
        out["nonlinear_latents_history"].numpy(),
        np.asarray(want["nonlinear_latents_history"]))
    np.testing.assert_allclose(out["log_marginal_likelihood"].numpy(),
                               np.asarray(want["log_marginal_likelihood"]),
                               rtol=1e-5)
    for name in ("filtered_means", "linear_means", "linear_means_history"):
        np.testing.assert_allclose(out[name].numpy(),
                                   np.asarray(want[name]), atol=1e-5)
    np.testing.assert_allclose(out["linear_covs"].numpy(),
                               np.asarray(want["linear_covs"]), atol=1e-5)


@pytest.mark.parametrize("method", ["systematic", "stratified"])
def test_cuda_route_launches_k1_or_k4_and_agrees(method, reference,
                                                 monkeypatch):
    """On the 'cuda' route (the wrappers' plain versions on CPU tensors)
    systematic resampling is K1 with no value columns, stratified K4, once
    a step; the ancestors, and so the filter, equal the 'torch' route's."""
    want = _port(reference, 4, method)
    calls = []
    k1 = resample_cuda.resample_and_gather_systematic
    k4 = searchsorted_sorted_cuda.searchsorted_sorted

    def spy_k1(cdf, u, value, emit_idx=True):
        calls.append(("K1", tuple(value.shape)))
        return k1(cdf, u, value, emit_idx)

    def spy_k4(cdf, pos):
        calls.append(("K4", tuple(pos.shape)))
        return k4(cdf, pos)

    monkeypatch.setattr(resampling, "resolve_implementation",
                        lambda *args: "cuda")
    monkeypatch.setattr(resample_cuda, "resample_and_gather_systematic",
                        spy_k1)
    monkeypatch.setattr(searchsorted_sorted_cuda, "searchsorted_sorted",
                        spy_k4)
    got = _port(reference, 4, method)
    expected = (("K1", (B, K, 0)) if method == "systematic" else
                ("K4", (B, K)))
    assert calls == [expected] * (T - 1)
    assert torch.equal(got["nonlinear_latents_history"],
                       want["nonlinear_latents_history"])
    assert torch.equal(got["log_marginal_likelihood"],
                       want["log_marginal_likelihood"])


@pytest.mark.parametrize("do", range(1, 10))
def test_psd_inverse_small_against_numpy(do):
    rng = np.random.default_rng(do)
    a = rng.normal(size=(6, do, do))
    s = (a @ a.transpose(0, 2, 1) + do * np.eye(do)).astype(np.float32)
    log_det, inv = rbpf._psd_inverse_small(torch.tensor(s))
    s64 = s.astype(np.float64)
    np.testing.assert_allclose(inv.numpy(), np.linalg.inv(s64), atol=1e-6)
    np.testing.assert_allclose(log_det.numpy(), np.linalg.slogdet(s64)[1],
                               atol=5e-6)


def _u_independent_problem(seed=2):
    """`tests/test_rbpf.py`'s oracle problem: linear parameters that do
    not depend on u, observations simulated from the model."""
    rng = np.random.default_rng(seed)
    a = np.array([[0.9, 0.1], [0.0, 0.8]])
    q, c, r = 0.5 * np.eye(2), np.array([[1.0, 0.5]]), np.array([[0.09]])
    m0, p0 = np.zeros(2), np.eye(2)
    obs = np.zeros((15, 3, 1))
    for b in range(3):
        x = rng.multivariate_normal(m0, p0)
        for t in range(15):
            if t > 0:
                x = a @ x + rng.multivariate_normal(np.zeros(2), q)
            obs[t, b] = c @ x + rng.multivariate_normal(np.zeros(1), r)

    def f(x):
        return torch.tensor(np.asarray(x, np.float32))

    comps = dict(
        initial=lambda: distributions.Normal(0.0, 1.0),
        transition=lambda previous_latents, time: distributions.Normal(
            0.5 * previous_latents[0], 1.0),
        linear_initial=lambda u0: (f(m0), f(p0)),
        linear_dynamics=lambda u, time: (f(a), f(np.zeros(2)), f(q)),
        linear_emission=lambda u, time: (f(c), f(np.zeros(1)), f(r)))
    return obs, comps, kalman_nd.KalmanNdParams(m0, p0, a, q, c, r)


@pytest.mark.parametrize("num_particles", [1, 7, 64])
def test_log_z_equals_kalman_for_any_k(num_particles):
    """With the u-draws not touching the linear part every particle has
    the same weight: no Monte Carlo error survives. The Normal prior is
    tagged FULLY_EXPANDED by `_tag_mode` (no inference warning)."""
    obs, comps, params = _u_independent_problem()
    out = rbpf.rbpf(torch.tensor(obs, dtype=torch.float32),
                    num_particles=num_particles,
                    noise=NoiseSource.seeded(num_particles, "cpu"),
                    **comps)
    for b in range(obs.shape[1]):
        exact = kalman_nd.kalman_filter_nd(obs[:, b], params)
        np.testing.assert_allclose(
            float(out["log_marginal_likelihood"][b]), exact[4], rtol=1e-5)
        np.testing.assert_allclose(out["filtered_means"][:, b].numpy(),
                                   exact[0], atol=1e-4)


def test_tag_mode_and_validation_errors():
    dist = distributions.Normal(torch.zeros(B, K), 1.0)
    tagged = rbpf._tag_mode({"u": dist}, B, K)["u"]
    assert tagged.batch_shape_mode == state.BatchShapeMode.FULLY_EXPANDED
    assert dist.batch_shape_mode is None
    obs = torch.zeros(4, B, 1)
    comps = _switching("torch", 1)
    with pytest.raises(ValueError, match="num_particles"):
        rbpf.rbpf(obs, num_particles=0, **comps)
    with pytest.raises(ValueError, match="ess_threshold"):
        rbpf.rbpf(obs, num_particles=4, ess_threshold=1.5, **comps)
    with pytest.raises(ValueError, match=r"\[T, B, Do\]"):
        rbpf.rbpf(torch.zeros(4, B, 1, 1), num_particles=4, **comps)
    with pytest.raises(ValueError, match="particle_axis"):
        rbpf.rbpf(obs, num_particles=4, mesh=IslandOnlyMesh(), **comps)
    # A plain callable passes through: the bits of the default route.
    plain = PlainSystematic()
    obs = torch.randn(4, B, 1)
    got = rbpf.rbpf(obs, num_particles=8, resampling_implementation=plain,
                    noise=NoiseSource.seeded(0, "cpu"), **comps)
    want = rbpf.rbpf(obs, num_particles=8,
                     noise=NoiseSource.seeded(0, "cpu"), **comps)
    assert plain.calls == 3
    for name in ("log_marginal_likelihood", "filtered_means"):
        torch.testing.assert_close(got[name], want[name], rtol=0, atol=0)
