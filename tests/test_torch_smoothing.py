"""The port's FFBS and PaRIS smoothers against the JAX package's, under
replayed draws, and the port's RTS oracle against the JAX package's.

Every draw of the JAX run is replayed into the port from the JAX key
schedule: FFBS's Gumbel noise (`[B, M, K]` for the last step, then one
`[B, M, K]` a step from `split(key, T-1)[t]`, last step first); PaRIS's
resampling uniforms (`split(key, (T, 3))[t, 0]`), proposal normals
(`[t, 1]`) and backward draws (`[t, 2]`: N Gumbel tiles `[B, K, K]` from
`split(key, N)`, or one `[B, chunk, K, N]` block a parent chunk stacked
from `fold_in(key, j)`). The rejection sampler's draws depend on how many
rounds run, so they are replayed lazily from the step's key
(`KeyChainNoise`: `split(key, 3)` a round, then the exact fallback's
Gumbel blocks from `fold_in(last key, chunk)`), handed to the port's
`_rejection_backward_indices` by the step's time. The JAX package's CDFs
are patched in (the filter's and the rejection proposals'), so that
every index compares exactly. LGSSM with the optimal proposal of the
JAX package's PaRIS tests, T = 5, B = 2, K = 32, M = 16 trajectories.

Tolerances: FFBS trajectories exactly equal (gathered particles); PaRIS
statistics and log-Z within 1e-4 absolute (float32 sums in another
order); the score within 1e-3 relative / 1e-3 absolute (forward-mode
Jacobians summed over T steps); `kalman_smoother` within 1e-10 (the same
float64 arithmetic).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aesmc_tpu import resampling as jax_resampling
from aesmc_tpu import smoothing as jax_smoothing
from aesmc_tpu.models import kalman as jax_kalman
from aesmc_tpu.models import lgssm as jax_lgssm
from aesmc_tpu_torch import distributions, resampling, smoothing
from aesmc_tpu_torch.models import kalman, lgssm
from aesmc_tpu_torch.state import BatchShapeMode
from torch_replay import (IslandOnlyMesh, ReplayNoise, lgssm_params,
                          normal_draw, tensor)

A, Q, EM, R0 = 0.9, 1.0, 1.0, 0.5
T, B, K, M, N = 5, 2, 32, 16, 2
KEY = jax.random.PRNGKey(0)


def _jax_components():
    prec_t = 1.0 / Q + EM ** 2 / R0
    prec_0 = 1.0 / 1.0 + EM ** 2 / R0
    return (jax_lgssm.Initial(0.0, 1.0),
            jax_lgssm.Transition.create(A, np.sqrt(Q)),
            jax_lgssm.Emission.create(EM, np.sqrt(R0)),
            jax_lgssm.Proposal(
                lin_0_weight=jnp.asarray((EM / R0) / prec_0),
                lin_0_bias=jnp.asarray(0.0),
                lin_t_weight=jnp.asarray([(A / Q) / prec_t,
                                          (EM / R0) / prec_t]),
                lin_t_bias=jnp.asarray(0.0),
                scale_0=float(np.sqrt(1.0 / prec_0)),
                scale_t=float(np.sqrt(1.0 / prec_t))))


def _components():
    jax_comps = _jax_components()
    return jax_comps, lgssm.from_numpy(lgssm_params(jax_comps), device="cpu")


def _observations(seed=11):
    rng = np.random.RandomState(seed)
    x = rng.randn(B)
    ys = []
    for _ in range(T):
        ys.append(EM * x + np.sqrt(R0) * rng.randn(B))
        x = A * x + np.sqrt(Q) * rng.randn(B)
    return np.asarray(ys, np.float32)


@pytest.fixture
def jax_cdfs(monkeypatch):
    """The JAX package's CDFs in the port: the filter's and the rejection
    proposals' (cumsum(softmax))."""
    def as_jax(fn):
        return lambda lw: tensor(fn(jnp.asarray(lw.detach().numpy())))

    monkeypatch.setattr(resampling, "_normalized_cumsum",
                        as_jax(jax_resampling._normalized_cumsum))
    monkeypatch.setattr(smoothing, "_weights_cdf", as_jax(
        lambda lw: jnp.cumsum(jax.nn.softmax(lw, axis=1), axis=1)))


class KeyChainNoise:
    """The JAX rejection sampler's draws from its key, made as the port
    asks for them: each round splits the key in three (the parent
    uniforms from the second, the acceptance uniforms from the third),
    and the exact fallback draws one Gumbel block a parent chunk from
    `fold_in(key after the last round, chunk)`."""

    device = torch.device("cpu")

    def __init__(self, key):
        self.key = key
        self.acceptance_key = None
        self.chunk = 0

    def uniform(self, shape):
        if self.acceptance_key is None:
            self.key, k1, self.acceptance_key = jax.random.split(self.key, 3)
            return tensor(jax.random.uniform(k1, shape))
        k2, self.acceptance_key = self.acceptance_key, None
        return tensor(jax.random.uniform(k2, shape, minval=1e-38))

    def gumbel(self, shape):
        g = jax.random.gumbel(jax.random.fold_in(self.key, self.chunk),
                              shape)
        self.chunk += 1
        return tensor(g)


def _route_rejection(monkeypatch, key_of_time):
    """Hands each call of the port's rejection sampler a `KeyChainNoise`
    from the key of its step (``key_of_time(time)``)."""
    original = smoothing._rejection_backward_indices

    def replayed(noise, *args, **kwargs):
        time = args[4]
        return original(KeyChainNoise(key_of_time(int(time))), *args,
                        **kwargs)

    monkeypatch.setattr(smoothing, "_rejection_backward_indices", replayed)


def _filter_output(jax_comps, obs):
    from aesmc_tpu import inference as jax_inference
    out = jax_inference.infer(
        "smc", jnp.asarray(obs), *jax_comps, K, key=jax.random.PRNGKey(1),
        return_original_latents=True, return_log_weights=True,
        return_latents=False, return_log_weight=False)
    return out["original_latents"], out["log_weights"]


@pytest.mark.parametrize("backward", ["pairwise", "rejection"])
def test_backward_simulation_matches_jax(backward, jax_cdfs, monkeypatch):
    jax_comps, comps = _components()
    obs = _observations()
    latents, log_weights = _filter_output(jax_comps, obs)
    key = jax.random.PRNGKey(2)
    want = jax_smoothing.backward_simulation(
        latents, log_weights, jax_comps[1], M, key,
        observations=jnp.asarray(obs), backward=backward)
    key_rest, sub = jax.random.split(key)
    step_keys = jax.random.split(key_rest, T - 1)
    gumbels = [jax.random.gumbel(sub, (B, M, K))]
    if backward == "pairwise":
        gumbels += [jax.random.gumbel(step_keys[t], (B, M, K))
                    for t in range(T - 2, -1, -1)]
    else:
        _route_rejection(monkeypatch, lambda time: step_keys[time - 1])
    noise = ReplayNoise(gumbels=gumbels)
    got = smoothing.backward_simulation(
        tensor(latents), tensor(log_weights), comps[1], M, noise,
        observations=tensor(obs), backward=backward)
    assert noise.exhausted() and got.shape == (T, B, M)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))


def _paris_noise(key, backward="pairwise", chunk=None):
    """The PaRIS run's resampling uniforms, proposal normals and ('pairwise'
    or 'chunked') backward Gumbel noise, from ``key``."""
    step_keys = jax.random.split(key, (T, 3))
    normals = [normal_draw(step_keys[0, 1], (K,), (B,), batch_expanded=True)]
    uniforms, gumbels = [], []
    for t in range(1, T):
        uniforms.append(np.asarray(jax.random.uniform(step_keys[t, 0],
                                                      (B, 1))))
        normals.append(normal_draw(step_keys[t, 1], (), (B, K)))
        if backward == "chunked":
            for start in range(0, K, chunk):
                gumbels.append(np.stack([np.asarray(jax.random.gumbel(
                    jax.random.fold_in(step_keys[t, 2], j), (B, K, N)))
                    for j in range(start, start + chunk)], axis=1))
        elif backward == "pairwise":
            gumbels += [np.asarray(jax.random.gumbel(k, (B, K, K)))
                        for k in jax.random.split(step_keys[t, 2], N)]
    return ReplayNoise(uniforms=uniforms, normals=normals,
                       gumbels=gumbels), step_keys


@pytest.mark.parametrize("backward", ["pairwise", "chunked", "rejection",
                                      "rejection_rounds"])
def test_paris_matches_jax(backward, jax_cdfs, monkeypatch):
    """'rejection' has room in its exact fallback for every lane, so it
    runs one round; 'rejection_rounds' (2 fallback lanes) loops until at
    most 2 lanes a batch are open."""
    jax_comps, comps = _components()
    obs = _observations(12)
    key = jax.random.PRNGKey(3)
    chunk = 8
    if backward == "chunked":
        # Below the wall: both packages stream parent chunks of 8.
        for module in (jax_smoothing, smoothing):
            monkeypatch.setattr(module, "PAIRWISE_DENSE_MAX_BYTES", 0)
            monkeypatch.setattr(module, "PAIRWISE_CHUNK_BYTES",
                                4 * B * K * N * chunk)
    mode = "rejection" if backward.startswith("rejection") else "pairwise"
    kwargs = dict(h=lambda xp, xc, t: xp * xc, h0=lambda x0: x0 * x0,
                  num_backward_draws=N, backward=mode)
    if backward == "rejection_rounds":
        kwargs["max_exact_lanes"] = 2
    want = jax_smoothing.paris(jnp.asarray(obs), *jax_comps, K, key=key,
                               **kwargs)
    noise, step_keys = _paris_noise(key, backward, chunk)
    if mode == "rejection":
        _route_rejection(monkeypatch, lambda time: step_keys[time, 2])
    with torch.no_grad():
        got = smoothing.paris(tensor(obs), *comps, K, noise=noise, **kwargs)
    assert noise.exhausted()
    for name in ("smoothed", "tau", "log_weight", "log_marginal_likelihood"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   atol=1e-4, err_msg=name)
    if mode == "rejection":
        np.testing.assert_allclose(got["backward_accept_rate"].numpy(),
                                   np.asarray(want["backward_accept_rate"]),
                                   atol=1e-6)
        np.testing.assert_array_equal(
            got["backward_unconverged"].numpy(),
            np.asarray(want["backward_unconverged"]))


def test_paris_score_matches_jax(jax_cdfs):
    jax_comps, comps = _components()
    obs = _observations(13)
    key = jax.random.PRNGKey(4)

    def jax_build(p):
        return (jax_comps[0], jax_lgssm.Transition(mult=p["a"],
                                                   scale=float(np.sqrt(Q))),
                jax_lgssm.Emission(mult=p["c"], scale=float(np.sqrt(R0))),
                jax_comps[3])

    def build(p):
        def transition(previous_latents=None, time=None,
                       previous_observations=None):
            return distributions.Normal(
                p["a"] * previous_latents[-1], float(np.sqrt(Q)),
                batch_shape_mode=BatchShapeMode.FULLY_EXPANDED)

        def emission(latents=None, time=None, previous_observations=None):
            return distributions.Normal(
                p["c"] * latents[-1], float(np.sqrt(R0)),
                batch_shape_mode=BatchShapeMode.FULLY_EXPANDED)

        return comps[0], transition, emission, comps[3]

    want = jax_smoothing.paris_score(
        jnp.asarray(obs), jax_build, {"a": jnp.asarray(A),
                                      "c": jnp.asarray(EM)}, K, key=key)
    noise, _ = _paris_noise(key)
    got = smoothing.paris_score(
        tensor(obs), build, {"a": torch.tensor(A), "c": torch.tensor(EM)},
        K, noise=noise)
    assert noise.exhausted()
    for name in ("a", "c"):
        assert got["score"][name].shape == (B,)
        np.testing.assert_allclose(got["score"][name].numpy(),
                                   np.asarray(want["score"][name]),
                                   rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(got["log_marginal_likelihood"].numpy(),
                               np.asarray(want["log_marginal_likelihood"]),
                               atol=1e-4)


def test_kalman_smoother_matches_jax_and_options_raise():
    params = dict(initial_mean=0.3, initial_variance=1.5,
                  transition_mult=0.8, transition_offset=0.1,
                  transition_variance=0.7, emission_mult=1.2,
                  emission_offset=-0.2, emission_variance=0.4)
    obs = np.random.RandomState(0).randn(12)
    got = kalman.kalman_smoother(obs, kalman.KalmanParams(**params))
    want = jax_kalman.kalman_smoother(obs, jax_kalman.KalmanParams(**params))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-10)

    _, comps = _components()
    obs = tensor(_observations())
    noise = ReplayNoise()
    # A mesh without the particle axis is refused (the mesh runs
    # themselves: tests/test_torch_mesh_algorithms.py).
    with pytest.raises(ValueError, match="particle_axis"):
        smoothing.paris(obs, *comps, K, h=lambda xp, xc, t: xc,
                        noise=noise, mesh=IslandOnlyMesh())
    with pytest.raises(ValueError, match="particle_axis"):
        smoothing.backward_simulation(torch.zeros(T, B, K),
                                      torch.zeros(T, B, K), comps[1], M,
                                      noise, mesh=IslandOnlyMesh())
    with pytest.raises(ValueError, match="backward"):
        smoothing.paris(obs, *comps, K, h=lambda xp, xc, t: xc,
                        noise=noise, backward="bogus")
    with pytest.raises(ValueError, match="num_backward_draws"):
        smoothing.paris(obs, *comps, K, h=lambda xp, xc, t: xc,
                        noise=noise, num_backward_draws=0)
    with pytest.raises(ValueError, match="pairwise"):
        smoothing.paris(obs, *comps, K, h=lambda xp, xc, t: xc,
                        noise=noise, pairwise="bogus")

    class NoMean(distributions.Distribution):
        batch_shape = (B, K)

    with pytest.raises(TypeError, match="transition_log_bound"):
        smoothing._auto_log_bound(lambda **kw: NoMean(),
                                  torch.zeros(B, K), 1, None)
