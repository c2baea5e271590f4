"""The port's twisted SMC (`aesmc_tpu_torch.twisted`) and the bouncing
ball's `gaussian_spec` against the JAX package's.

Draws are replayed from the JAX key schedule: `infer`'s `split(key, (T,
2))[t]` = (resampling, proposal), the t = 0 proposal a BATCH_EXPANDED draw
(`[K, B, ...]` in JAX, swapped); the refit's design points
`split(fit_key, T)[t]` = split into (categorical, jitter), one `[K, K]`
Gumbel draw a batch row from `split(kc, B)[b]` (the shape in which
`jax.random.categorical(k, lw, shape=(K,))` draws), drawn for t = T-1
down to 0; `learn_twist`'s iterations `key, subkey, fit_key = split(key,
3)` and the 'best' scoring `key, subkey = split(key)`, `split(subkey, S)`
seeds in order. The JAX package's CDF is patched in where ancestors are
compared.

Tolerances: exact twists within 1e-12 in float64 and 1e-5 relative in
float32; the twisted filters (float32) within 1e-5 relative in log-Z,
log-weights and latents (the final step's psitilde term is exactly 0 in
the port's eager loop and 0 up to rounding under the JAX package's traced
time), ancestors exact; `learn_twist` in float64 within 1e-8 relative (the
same regressions, solved by another LU); the JAX package's own oracles on
the port in float64 (zero variance within 1e-8, evidence within 1e-8 of
Kalman / the forward recursion, the one-pass recovery within 1e-7).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aesmc_tpu import distributions as jax_dists
from aesmc_tpu import resampling as jax_resampling
from aesmc_tpu import twisted as jax_twisted
from aesmc_tpu.models import bouncing_ball as jax_bb
from aesmc_tpu.models import hmm as jax_hmm
from aesmc_tpu.models import kalman as jax_kalman
from aesmc_tpu.state import BatchShapeMode as JaxMode
from aesmc_tpu_torch import distributions as dists
from aesmc_tpu_torch import inference, resampling, twisted
from aesmc_tpu_torch.inference import DeviceTimeIndex, TimeIndex
from aesmc_tpu_torch.models import bouncing_ball, hmm
from aesmc_tpu_torch.noise import NoiseSource
from aesmc_tpu_torch.state import BatchShapeMode
from torch_replay import IslandOnlyMesh, ReplayNoise, mlp_fields, tensor

A_TR, S_TR, C_EM, S_EM = 0.9, 1.0, 1.2, 0.5
CPU = torch.device("cpu")


class Float64Noise(NoiseSource):
    """A seeded CPU source whose draws are float64, for the float64 oracles
    (the default source draws float32)."""

    def __init__(self, seed):
        super().__init__(torch.Generator().manual_seed(seed))

    def uniform(self, shape):
        return super().uniform(shape).double()

    def normal(self, shape):
        return super().normal(shape).double()

    def gumbel(self, shape):
        return super().gumbel(shape).double()

    def exponential(self, shape):
        return super().exponential(shape).double()


@pytest.fixture
def jax_cdf(monkeypatch):
    monkeypatch.setattr(resampling, "_normalized_cumsum", lambda lw: tensor(
        jax_resampling._normalized_cumsum(jnp.asarray(lw.detach().numpy()))))


def _lgssm_obs(num_timesteps, batch, seed=0, dim=None, dtype=np.float32):
    rng = np.random.RandomState(seed)
    shape = (batch,) if dim is None else (batch, dim)
    x = rng.randn(*shape)
    ys = []
    for _ in range(num_timesteps):
        ys.append(C_EM * x + S_EM * rng.randn(*shape))
        x = A_TR * x + S_TR * rng.randn(*shape)
    return np.asarray(ys, dtype)


def _emission(lib, vector=False):
    """y = C x + N(0, S_EM^2) in either package."""
    def emission(latents=None, time=None, previous_observations=None):
        x = latents[-1]
        if lib == "jax":
            if vector:
                return jax_dists.MultivariateNormalDiag(
                    C_EM * x, jnp.full(x.shape, S_EM, x.dtype),
                    batch_shape_mode=JaxMode.FULLY_EXPANDED)
            return jax_dists.Normal(C_EM * x, S_EM,
                                    batch_shape_mode=JaxMode.FULLY_EXPANDED)
        if vector:
            return dists.MultivariateNormalDiag(
                C_EM * x, torch.full_like(x, S_EM),
                batch_shape_mode=BatchShapeMode.FULLY_EXPANDED)
        return dists.Normal(C_EM * x, S_EM,
                            batch_shape_mode=BatchShapeMode.FULLY_EXPANDED)
    return emission


def _spec(lib, vector=False, scale_fn=False):
    if lib == "jax":
        spec = jax_twisted.GaussianSSMSpec
        loc, scale = ((jnp.zeros(2), jnp.ones(2)) if vector else (0.0, 1.0))
        sfn = (lambda x, t: 0.8 + 0.3 * jnp.tanh(x)) if scale_fn else None
    else:
        spec = twisted.GaussianSSMSpec
        loc, scale = ((torch.zeros(2), torch.ones(2)) if vector
                      else (0.0, 1.0))
        sfn = (lambda x, t: 0.8 + 0.3 * torch.tanh(x)) if scale_fn else None
    return spec(initial_loc=loc, initial_scale=scale, transition_scale=S_TR,
                mean_fn=lambda x, t: A_TR * x, scale_fn=sfn)


def _smc_draws(key, num_timesteps, batch, k, tail=(), dtype=jnp.float32):
    """`infer`'s draws from ``key``: the t = 0 BATCH_EXPANDED proposal's
    normals (swapped to `[B, K, ...]`), then per step the systematic
    uniforms and the FULLY_EXPANDED proposal's normals."""
    keys = jax.random.split(key, (num_timesteps, 2))
    normals = [np.swapaxes(np.asarray(jax.random.normal(
        keys[0, 1], (k, batch) + tail, dtype)), 0, 1)]
    uniforms = []
    for t in range(1, num_timesteps):
        uniforms.append(np.asarray(jax.random.uniform(keys[t, 0],
                                                      (batch, 1), dtype)))
        normals.append(np.asarray(jax.random.normal(
            keys[t, 1], (batch, k) + tail, dtype)))
    return {"uniforms": uniforms, "normals": normals}


def _hmm_draws(key, num_timesteps, batch, k, num_states, dtype=jnp.float32):
    """`infer`'s draws for a categorical proposal: the Gumbel noise in
    `jax.random.categorical`'s shapes (`[K, B, D]` at t = 0) and the
    systematic uniforms."""
    keys = jax.random.split(key, (num_timesteps, 2))
    gumbels = [np.asarray(jax.random.gumbel(keys[0, 1],
                                            (k, batch, num_states), dtype))]
    uniforms = []
    for t in range(1, num_timesteps):
        uniforms.append(np.asarray(jax.random.uniform(keys[t, 0],
                                                      (batch, 1), dtype)))
        gumbels.append(np.asarray(jax.random.gumbel(
            keys[t, 1], (batch, k, num_states), dtype)))
    return {"uniforms": uniforms, "gumbels": gumbels}


def _port_twist(tw):
    if isinstance(tw, jax_twisted.TabularTwist):
        return twisted.TabularTwist(logpsi=tensor(tw.logpsi))
    return twisted.QuadraticTwist(A=tensor(tw.A), b=tensor(tw.b),
                                  c=tensor(tw.c))


# ---- exact twists.

@pytest.mark.parametrize("dtype,tol", [(np.float64, dict(rtol=0, atol=1e-12)),
                                       (np.float32, dict(rtol=1e-5,
                                                         atol=1e-5))])
@pytest.mark.parametrize("vector", [False, True])
def test_exact_lgssm_twist_matches_jax(dtype, tol, vector):
    obs = _lgssm_obs(10, 3, dim=2 if vector else None, dtype=dtype)
    params = ((np.array([0.9, 0.5], dtype), np.array([1.0, 0.7], dtype),
               np.array([1.2, 0.8], dtype), np.array([0.5, 0.4], dtype))
              if vector else (A_TR, S_TR, C_EM, S_EM))
    with jax.enable_x64(dtype == np.float64):
        want = jax_twisted.exact_lgssm_twist(
            jnp.asarray(obs), 0.0, 1.0, *[jnp.asarray(p) for p in params])
        want = [np.asarray(x) for x in (want.A, want.b, want.c)]
    got = twisted.exact_lgssm_twist(
        torch.tensor(obs), 0.0, 1.0,
        *[torch.tensor(p) if vector else p for p in params])
    for g, w in zip((got.A, got.b, got.c), want):
        assert g.dtype == torch.from_numpy(obs).dtype
        np.testing.assert_allclose(g.numpy(), w, **tol)


def _hmm_problem(num_states=3, num_timesteps=8, batch=2, seed=5):
    comps = jax_hmm.make_model(num_states=num_states, emission_scale=0.6,
                               stay_prob=0.85, proposal="bootstrap")
    rng = np.random.RandomState(seed)
    locs = np.asarray(comps[2].locs)
    states = rng.randint(0, num_states, (num_timesteps, batch))
    obs = (locs[states] + 0.6 * rng.randn(num_timesteps, batch))
    return comps, obs


def _hmm_modules(comps):
    """The port's HMM modules with the JAX components' numbers."""
    initial, transition, emission, _ = comps
    logits = {"initial_logits": np.asarray(initial.logits),
              "transition_logits": np.asarray(transition.logits)}
    return hmm.from_numpy({
        "initial": {"logits": logits["initial_logits"]},
        "transition": {"logits": logits["transition_logits"]},
        "emission": {"locs": np.asarray(emission.locs),
                     "scale": emission.scale},
        "proposal": logits}, device="cpu")


@pytest.mark.parametrize("dtype,tol", [(np.float64, dict(rtol=0, atol=1e-12)),
                                       (np.float32, dict(rtol=1e-5,
                                                         atol=1e-5))])
@pytest.mark.parametrize("form", ["params", "logliks"])
def test_exact_hmm_twist_matches_jax(dtype, tol, form):
    comps, obs = _hmm_problem(num_states=4)
    initial, transition, emission, _ = comps
    obs = obs.astype(dtype)
    logits = np.asarray(transition.logits, dtype)
    locs = np.asarray(emission.locs, dtype)
    ll = (-0.5 * ((obs[:, :, None] - locs) / emission.scale) ** 2
          - np.log(emission.scale) - 0.5 * np.log(2 * np.pi)).astype(dtype)
    with jax.enable_x64(dtype == np.float64):
        if form == "params":
            want = jax_twisted.exact_hmm_twist(
                jnp.asarray(obs), None, jnp.asarray(logits),
                jnp.asarray(locs), emission.scale)
        else:
            want = jax_twisted.exact_hmm_twist(
                jnp.asarray(obs), None, jnp.asarray(logits),
                emission_logliks=jnp.asarray(ll))
        want = np.asarray(want.logpsi)
    if form == "params":
        got = twisted.exact_hmm_twist(torch.tensor(obs), None,
                                      torch.tensor(logits),
                                      torch.tensor(locs), emission.scale)
    else:
        got = twisted.exact_hmm_twist(torch.tensor(obs), None,
                                      torch.tensor(logits),
                                      emission_logliks=torch.tensor(ll))
    assert got.num_states == 4 and got.logpsi.dtype == torch.from_numpy(
        obs).dtype
    np.testing.assert_allclose(got.logpsi.numpy(), want, **tol)


# ---- the twisted filters against the JAX package's, float32.

T, B, K = 8, 2, 32


def _continuous_case(case):
    vector = case == "vector"
    scale_fn = case == "scale_fn"
    obs = _lgssm_obs(T, B, seed=3, dim=2 if vector else None)
    exact = jax_twisted.exact_lgssm_twist(jnp.asarray(obs), 0.0, 1.0, A_TR,
                                          S_TR, C_EM, S_EM)
    rng = np.random.RandomState(4)
    # A twist away from the optimum, so that the weights vary.
    tw = jax_twisted.QuadraticTwist(
        A=0.6 * exact.A,
        b=0.6 * exact.b + jnp.asarray(0.2 * rng.randn(*exact.b.shape),
                                      jnp.float32),
        c=0.6 * exact.c)
    return obs, tw, vector, scale_fn


@pytest.mark.parametrize("case", ["scalar", "vector", "scale_fn"])
def test_continuous_twisted_smc_replays_jax(jax_cdf, case):
    obs, tw, vector, scale_fn = _continuous_case(case)
    key = jax.random.PRNGKey(11)
    kwargs = dict(return_log_weights=True, return_original_latents=True,
                  return_ancestral_indices=True)
    want = jax_twisted.twisted_smc(
        jnp.asarray(obs), _spec("jax", vector, scale_fn),
        _emission("jax", vector), tw, K, key=key, **kwargs)
    noise = ReplayNoise(**_smc_draws(key, T, B, K, (2,) if vector else ()))
    with torch.no_grad():
        got = twisted.twisted_smc(
            torch.tensor(obs), _spec("torch", vector, scale_fn),
            _emission("torch", vector), _port_twist(tw), K, noise=noise,
            **kwargs)
    assert noise.exhausted()
    np.testing.assert_array_equal(got["ancestral_indices"].numpy(),
                                  np.asarray(want["ancestral_indices"]))
    for name in ("log_marginal_likelihood", "log_weights", "log_weight",
                 "original_latents", "latents"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


def test_discrete_twisted_smc_replays_jax(jax_cdf):
    comps, obs = _hmm_problem(num_states=3, num_timesteps=T, batch=B)
    initial, transition, emission, _ = comps
    obs = obs.astype(np.float32)
    exact = jax_twisted.exact_hmm_twist(jnp.asarray(obs), initial.logits,
                                        transition.logits, emission.locs,
                                        emission.scale)
    rng = np.random.RandomState(2)
    tw = jax_twisted.TabularTwist(logpsi=0.5 * exact.logpsi + jnp.asarray(
        rng.randn(*exact.logpsi.shape), jnp.float32))
    spec = jax_twisted.DiscreteSSMSpec(initial.logits, transition.logits)
    key = jax.random.PRNGKey(12)
    kwargs = dict(return_log_weights=True, return_original_latents=True,
                  return_ancestral_indices=True)
    want = jax_twisted.twisted_smc(jnp.asarray(obs), spec, emission, tw, K,
                                   key=key, **kwargs)
    port_comps = _hmm_modules(comps)
    noise = ReplayNoise(**_hmm_draws(key, T, B, K, 3))
    with torch.no_grad():
        got = twisted.twisted_smc(
            torch.tensor(obs), twisted.DiscreteSSMSpec(
                port_comps[0].logits, port_comps[1].logits),
            port_comps[2], _port_twist(tw), K, noise=noise, **kwargs)
    assert noise.exhausted()
    assert got["original_latents"].dtype == torch.int32
    for name in ("ancestral_indices", "original_latents", "latents"):
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]), err_msg=name)
    for name in ("log_marginal_likelihood", "log_weights", "log_weight"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


def test_twist_validation_errors():
    obs = torch.tensor(_lgssm_obs(6, 3))
    spec, em = _spec("torch"), _emission("torch")
    with pytest.raises(ValueError, match="covers 5 steps"):
        twisted.twisted_smc(obs, spec, em,
                            twisted.QuadraticTwist.zeros(5, 3, device=CPU), 8)
    tw = twisted.QuadraticTwist.zeros(6, 3, device=CPU)
    with pytest.raises(ValueError, match="leading"):
        twisted.twisted_smc(obs, spec, em, twisted.QuadraticTwist(
            A=tw.A, b=tw.b[:4], c=tw.c), 8)
    hspec = twisted.DiscreteSSMSpec(torch.zeros(3), torch.zeros(3, 3))
    with pytest.raises(ValueError, match="covers 5 steps"):
        twisted.twisted_smc(obs, hspec, em,
                            twisted.TabularTwist.zeros(5, 3, 3, device=CPU),
                            8)
    with pytest.raises(ValueError, match="must be"):
        twisted.twisted_smc(obs, hspec, em,
                            twisted.TabularTwist(torch.zeros(6, 3)), 8)
    with pytest.raises(ValueError, match="particle_axis"):
        twisted.twisted_smc(obs, spec, em, tw, 8, mesh=IslandOnlyMesh())
    with pytest.raises(ValueError, match="particle_axis"):
        twisted.learn_twist(obs, spec, em, 8, mesh=IslandOnlyMesh())
    with pytest.raises(ValueError, match="keep"):
        twisted.learn_twist(obs, spec, em, 8, keep="first")


def test_time_indexed_mean_fn_final_step():
    """A mean_fn indexing a `[T]` table by time is never asked for index T:
    the last step skips the psitilde term (an int time), and T = 1 too."""
    coef = torch.tensor([0.9, 0.8, 0.7, 0.6, 0.5])
    spec = twisted.GaussianSSMSpec(0.0, 1.0, 1.0,
                                   mean_fn=lambda x, t: coef[t] * x)
    for num_timesteps in (5, 1):
        obs = torch.tensor(_lgssm_obs(num_timesteps, 2))
        out = twisted.twisted_smc(
            obs, spec, _emission("torch"),
            twisted.QuadraticTwist.zeros(num_timesteps, 2, device=CPU), 16,
            noise=NoiseSource.seeded(1, CPU))
        assert bool(torch.isfinite(out["log_marginal_likelihood"]).all())


@pytest.mark.parametrize("discrete", [False, True])
def test_device_time_matches_int_time(discrete):
    """Under a `DeviceTimeIndex` (the streaming filter's time) the
    components give the int time's distributions; at the last step the
    clamped psitilde term is 0 up to rounding, as under the JAX package's
    traced time."""
    num_timesteps = 5
    rng = np.random.RandomState(0)
    if discrete:
        comps, obs = _hmm_problem(num_timesteps=num_timesteps, batch=2)
        port = _hmm_modules(comps)
        tw = twisted.TabularTwist(torch.tensor(
            rng.randn(num_timesteps, 2, 3), dtype=torch.float32))
        made = twisted.make_discrete_twisted_components(
            twisted.DiscreteSSMSpec(port[0].logits, port[1].logits),
            port[2], tw, 2, num_timesteps)
        x = torch.tensor(rng.randint(0, 3, (2, 6)), dtype=torch.int32)
        y = torch.tensor(obs[0, :, None].repeat(6, 1), dtype=torch.float32)
    else:
        tw = twisted.QuadraticTwist(
            A=torch.rand(num_timesteps, 2), b=torch.randn(num_timesteps, 2),
            c=torch.randn(num_timesteps, 2))
        made = twisted.make_twisted_components(
            _spec("torch"), _emission("torch"), tw, 2, num_timesteps)
        x = torch.randn(2, 6)
        y = torch.randn(2, 6)
    _, transition, emission, _ = made
    for t in range(1, num_timesteps):
        device_t = DeviceTimeIndex(torch.tensor(t, dtype=torch.int32))
        a = emission(latents=[x], time=TimeIndex(t)).log_prob(y)
        b = emission(latents=[x], time=device_t).log_prob(y)
        torch.testing.assert_close(b, a, rtol=0, atol=1e-5)
        if t + 1 < num_timesteps:
            torch.testing.assert_close(b, a, rtol=0, atol=0)
        ta = transition(previous_latents=[x], time=TimeIndex(t))
        tb = transition(previous_latents=[x], time=device_t)
        for field in ("logits",) if discrete else ("loc", "scale"):
            assert torch.equal(getattr(ta, field), getattr(tb, field))


def test_log_corrected_distribution():
    base = dists.MultivariateNormalDiag(
        torch.zeros(2, 3, 4), torch.ones(2, 3, 4),
        batch_shape_mode=BatchShapeMode.FULLY_EXPANDED)
    corr = torch.randn(2, 3)
    d = twisted.LogCorrectedDistribution(
        base, corr, batch_shape_mode=BatchShapeMode.FULLY_EXPANDED)
    assert d.batch_shape == (2, 3) and d.event_shape == (4,)
    v = torch.randn(2, 3, 4)
    torch.testing.assert_close(d.log_prob(v), base.log_prob(v) + corr)
    eps = torch.randn(2, 3, 4)
    assert torch.equal(d.rsample((), eps), base.rsample((), eps))
    # Extra dims of the base's log-density are summed.
    per_dim = twisted.LogCorrectedDistribution(
        dists.Normal(torch.zeros(2, 3, 4), 1.0), corr)
    torch.testing.assert_close(per_dim.log_prob(v),
                               dists.Normal(0.0, 1.0).log_prob(v).sum(-1)
                               + corr)


# ---- the JAX package's oracles on the port, float64.

def _kalman_loglik(obs):
    params = jax_kalman.KalmanParams(0.0, 1.0, A_TR, 0.0, S_TR ** 2, C_EM,
                                     0.0, S_EM ** 2)
    return np.array([jax_kalman.kalman_filter(obs[:, b], params)[-1]
                     for b in range(obs.shape[1])])


@pytest.mark.parametrize("seed,k", [(0, 2), (5, 17), (9, 64)])
def test_exact_lgssm_twist_zero_variance(seed, k):
    obs = _lgssm_obs(12, 3, seed=7, dtype=np.float64)
    tw = twisted.exact_lgssm_twist(torch.tensor(obs), 0.0, 1.0, A_TR, S_TR,
                                   C_EM, S_EM)
    out = twisted.twisted_smc(torch.tensor(obs), _spec("torch"),
                              _emission("torch"), tw, k,
                              noise=Float64Noise(seed),
                              return_log_weights=True)
    lw = out["log_weights"]
    assert float((lw - lw.mean(2, keepdim=True)).abs().max()) < 1e-8
    np.testing.assert_allclose(out["log_marginal_likelihood"].numpy(),
                               _kalman_loglik(obs), rtol=0, atol=1e-8)


def test_exact_vector_twist_evidence():
    a, s_tr = np.array([0.9, 0.5]), np.array([1.0, 0.7])
    c_em, s_em = np.array([1.2, 0.8]), np.array([0.5, 0.4])
    rng = np.random.RandomState(3)
    x, ys = rng.randn(2, 2), []
    for _ in range(10):
        ys.append(c_em * x + s_em * rng.randn(2, 2))
        x = a * x + s_tr * rng.randn(2, 2)
    obs = np.asarray(ys)
    ta, ts, tc, te = (torch.tensor(v) for v in (a, s_tr, c_em, s_em))

    def emission(latents=None, time=None, previous_observations=None):
        return dists.MultivariateNormalDiag(
            tc * latents[-1], te.expand_as(latents[-1]),
            batch_shape_mode=BatchShapeMode.FULLY_EXPANDED)

    spec = twisted.GaussianSSMSpec(torch.zeros(2, dtype=torch.float64),
                                   torch.ones(2, dtype=torch.float64), ts,
                                   mean_fn=lambda x_, t: ta * x_)
    tw = twisted.exact_lgssm_twist(torch.tensor(obs), 0.0, 1.0, ta, ts, tc,
                                   te)
    out = twisted.twisted_smc(torch.tensor(obs), spec, emission, tw, 6,
                              noise=Float64Noise(11))
    exact = np.zeros(2)
    for d in range(2):
        params = jax_kalman.KalmanParams(0.0, 1.0, a[d], 0.0, s_tr[d] ** 2,
                                         c_em[d], 0.0, s_em[d] ** 2)
        exact += [jax_kalman.kalman_filter(obs[:, b, d], params)[-1]
                  for b in range(2)]
    np.testing.assert_allclose(out["log_marginal_likelihood"].numpy(), exact,
                               rtol=0, atol=1e-8)


def _port_hmm(comps, dtype=torch.float64):
    initial, transition, emission, _ = comps

    def em(latents=None, time=None, previous_observations=None):
        locs = torch.tensor(np.asarray(emission.locs, np.float64)).to(dtype)
        return dists.Normal(locs[latents[-1].long()], emission.scale,
                            batch_shape_mode=BatchShapeMode.FULLY_EXPANDED)

    spec = twisted.DiscreteSSMSpec(
        torch.tensor(np.asarray(initial.logits, np.float64)),
        torch.tensor(np.asarray(transition.logits, np.float64)))
    return spec, em


@pytest.mark.parametrize("seed,k", [(0, 2), (5, 17), (9, 64)])
def test_exact_hmm_twist_zero_variance(seed, k):
    comps, obs = _hmm_problem(num_states=4, num_timesteps=12, batch=3)
    initial, transition, emission, _ = comps
    spec, em = _port_hmm(comps)
    tw = twisted.exact_hmm_twist(torch.tensor(obs), None,
                                 spec.transition_logits,
                                 torch.tensor(np.asarray(emission.locs,
                                                         np.float64)),
                                 emission.scale)
    out = twisted.twisted_smc(torch.tensor(obs), spec, em, tw, k,
                              noise=Float64Noise(seed),
                              return_log_weights=True)
    lw = out["log_weights"]
    assert float((lw - lw.mean(2, keepdim=True)).abs().max()) < 1e-8
    exact = [hmm.hmm_forward(obs[:, b], np.asarray(initial.logits),
                             np.asarray(transition.logits),
                             np.asarray(emission.locs), emission.scale)[1]
             for b in range(3)]
    np.testing.assert_allclose(out["log_marginal_likelihood"].numpy(), exact,
                               rtol=0, atol=1e-8)


def test_zero_tabular_twist_is_bootstrap():
    """The zero table: every step's weight is the emission log-likelihood
    at the run's own particles."""
    comps, obs = _hmm_problem(num_states=3, num_timesteps=10, batch=2)
    spec, em = _port_hmm(comps)
    out = twisted.twisted_smc(
        torch.tensor(obs), spec, em,
        twisted.TabularTwist.zeros(10, 2, 3, torch.float64, device=CPU), 32,
        noise=Float64Noise(3), return_log_weights=True,
        return_original_latents=True)
    x = out["original_latents"].long().numpy()
    locs = np.asarray(comps[2].locs, np.float64)
    want = (-0.5 * ((obs[:, :, None] - locs[x]) / 0.6) ** 2
            - 0.5 * np.log(2 * np.pi * 0.36))
    np.testing.assert_allclose(out["log_weights"].numpy(), want, atol=1e-12)


def test_zero_twist_is_bootstrap_infer():
    """The zero quadratic twist is the bootstrap filter: the same noise
    gives the port's bootstrap `infer`'s log-Z and latents."""
    obs = torch.tensor(_lgssm_obs(12, 3, dtype=np.float64))
    tw = twisted.QuadraticTwist.zeros(12, 3, dtype=torch.float64, device=CPU)
    got = twisted.twisted_smc(obs, _spec("torch"), _emission("torch"), tw,
                              32, noise=Float64Noise(4))

    def initial():
        return dists.Normal(0.0, 1.0)

    def transition(previous_latents=None, time=None,
                   previous_observations=None):
        return dists.Normal(A_TR * previous_latents[-1], S_TR,
                            batch_shape_mode=BatchShapeMode.FULLY_EXPANDED)

    def proposal(previous_latents=None, time=None, observations=None):
        if time == 0:
            return dists.Normal(torch.zeros(3, dtype=torch.float64),
                                torch.ones(3, dtype=torch.float64),
                                batch_shape_mode=BatchShapeMode.BATCH_EXPANDED)
        return transition(previous_latents=previous_latents, time=time)

    want = inference.infer("smc", obs, initial, transition,
                           _emission("torch"), proposal, 32,
                           noise=Float64Noise(4),
                           return_log_marginal_likelihood=True)
    np.testing.assert_allclose(got["log_marginal_likelihood"].numpy(),
                               want["log_marginal_likelihood"].numpy(),
                               rtol=0, atol=1e-9)
    np.testing.assert_allclose(got["latents"].numpy(),
                               want["latents"].numpy(), rtol=0, atol=1e-9)


# ---- _fit_quadratic.

@pytest.mark.parametrize("vector", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
def test_fit_quadratic_matches_jax(vector, weighted):
    rng = np.random.RandomState(1 + vector + 2 * weighted)
    shape = (3, 64, 2) if vector else (3, 64)
    x = rng.randn(*shape)
    xm = x if vector else x[..., None]
    target = (-0.7 * np.sum(xm ** 2, -1) + 0.4 * np.sum(xm, -1) + 0.3
              + 0.1 * rng.randn(3, 64))
    w = None
    if weighted:
        lw = rng.randn(3, 64)
        w = np.exp(lw - np.log(np.exp(lw).sum(1, keepdims=True)))
    with jax.enable_x64(True):
        fit = jax.vmap(jax_twisted._fit_quadratic,
                       in_axes=(0, 0, None, None if w is None else 0))
        want = fit(jnp.asarray(x), jnp.asarray(target), 1e-6,
                   None if w is None else jnp.asarray(w))
        want = [np.asarray(v) for v in want]
    got = twisted._fit_quadratic(torch.tensor(x), torch.tensor(target), 1e-6,
                                 None if w is None else torch.tensor(w))
    for g, v in zip(got, want):
        assert tuple(g.shape) == v.shape
        np.testing.assert_allclose(g.numpy(), v, rtol=1e-9, atol=1e-10)


def test_fit_quadratic_degenerate_cloud_gives_zero_row():
    """Duplicated particles and ridge 0: the Gram is singular, and the row
    falls back to the zero twist (the JAX package's answer for these
    rows); a healthy row beside it is fitted as alone."""
    rng = np.random.RandomState(0)
    x = np.stack([np.zeros(64), rng.randn(64)])
    target = np.stack([np.full(64, -0.7), -0.5 * x[1] ** 2 + x[1]])
    with jax.enable_x64(True):
        want = [np.asarray(v) for v in jax.vmap(
            jax_twisted._fit_quadratic, in_axes=(0, 0, None, None))(
                jnp.asarray(x), jnp.asarray(target), 0.0, None)]
    got = twisted._fit_quadratic(torch.tensor(x), torch.tensor(target), 0.0)
    for g, v in zip(got, want):
        assert bool(torch.isfinite(g).all())
        assert float(g[0]) == 0.0 and float(v[0]) == 0.0
        np.testing.assert_allclose(g[1].numpy(), v[1], rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose([float(got[0][1]), float(got[1][1])],
                               [1.0, 1.0], rtol=1e-9)
    # float32, all particles equal at x = 1.3 (tests/test_twisted.py's
    # cloud): finite, A >= 0.
    a, b, c = twisted._fit_quadratic(torch.full((1, 64), 1.3),
                                     torch.full((1, 64), -0.7), 0.0)
    assert all(bool(torch.isfinite(v).all()) for v in (a, b, c))
    assert float(a[0]) >= 0.0


def test_fit_quadratic_constrained_refit():
    """A convex-up target: A clamps to 0 and (b, c) is the best affine
    fit."""
    rng = np.random.RandomState(0)
    x = rng.randn(2, 256)
    target = 0.5 * x ** 2 + 0.3 * x - 0.1
    a, b, c = twisted._fit_quadratic(torch.tensor(x), torch.tensor(target),
                                     0.0)
    assert torch.equal(a, torch.zeros(2, dtype=torch.float64))
    for row in range(2):
        phi = np.stack([x[row], np.ones(256)], 1)
        bc = np.linalg.lstsq(phi, target[row], rcond=None)[0]
        np.testing.assert_allclose([float(b[row]), float(c[row])], bc,
                                   atol=1e-10)


# ---- learn_twist.

LT, LB, LK, LK_SCORE, LSEEDS = 8, 2, 64, 32, 2


def _sv_problem():
    """Stochastic volatility (mu, phi, sigma, beta) = (0, 0.9, 0.8, 0.7),
    float64, observations from a numpy seed."""
    phi, sigma, beta = 0.9, 0.8, 0.7
    rng = np.random.RandomState(21)
    x = sigma / np.sqrt(1 - phi ** 2) * rng.randn(LB)
    ys = []
    for _ in range(LT):
        ys.append(beta * np.exp(x / 2) * rng.randn(LB))
        x = phi * x + sigma * rng.randn(LB)
    obs = np.asarray(ys)

    def emission(lib):
        def jax_emission(latents=None, time=None, previous_observations=None):
            return jax_dists.Normal(jnp.zeros_like(latents[-1]),
                                    beta * jnp.exp(latents[-1] / 2),
                                    batch_shape_mode=JaxMode.FULLY_EXPANDED)

        def port_emission(latents=None, time=None,
                          previous_observations=None):
            return dists.Normal(torch.zeros_like(latents[-1]),
                                beta * torch.exp(latents[-1] / 2),
                                batch_shape_mode=BatchShapeMode.FULLY_EXPANDED)
        return jax_emission if lib == "jax" else port_emission

    def spec(lib):
        cls = (jax_twisted.GaussianSSMSpec if lib == "jax"
               else twisted.GaussianSSMSpec)
        return cls(initial_loc=0.0,
                   initial_scale=sigma / np.sqrt(1 - phi ** 2),
                   transition_scale=sigma, mean_fn=lambda x, t: phi * x)

    return obs, emission, spec


def _refit_draws(fit_key, num_timesteps, batch, k, jitter, dtype):
    """The design-point draws of `_adp_refit`, t = T-1 down to 0."""
    gumbels, normals = [], []
    if not jitter:
        return gumbels, normals
    step_keys = jax.random.split(fit_key, num_timesteps)
    for t in range(num_timesteps - 1, -1, -1):
        kc, kn = jax.random.split(step_keys[t])
        rows = jax.random.split(kc, batch)
        gumbels.append(np.stack([np.asarray(jax.random.gumbel(
            rows[b], (k, k), dtype)) for b in range(batch)]))
        normals.append(np.asarray(jax.random.normal(kn, (batch, k), dtype)))
    return gumbels, normals


def _learn_draws(key, num_iterations, jitter, keep, num_seeds):
    dtype = jnp.float64
    draws = {"uniforms": [], "normals": [], "gumbels": []}
    for _ in range(num_iterations):
        key, subkey, fit_key = jax.random.split(key, 3)
        run = _smc_draws(subkey, LT, LB, LK, dtype=dtype)
        draws["uniforms"] += run["uniforms"]
        draws["normals"] += run["normals"]
        gumbels, normals = _refit_draws(fit_key, LT, LB, LK, jitter, dtype)
        draws["gumbels"] += gumbels
        draws["normals"] += normals
    if keep == "best":
        for _ in range(num_iterations + 1):
            key, subkey = jax.random.split(key)
            for seed_key in jax.random.split(subkey, num_seeds):
                run = _smc_draws(seed_key, LT, LB, LK_SCORE, dtype=dtype)
                draws["uniforms"] += run["uniforms"]
                draws["normals"] += run["normals"]
    return draws


@pytest.mark.parametrize("options", [
    dict(keep="last"),
    dict(keep="last", weighted=False, num_iterations=1),
    dict(keep="last", fit_jitter=1.5, damping=0.3, max_precision_ratio=2.0),
    dict(keep="best", fit_jitter=1.5, keep_num_particles=LK_SCORE,
         keep_num_seeds=LSEEDS),
], ids=["last", "unweighted", "jitter-damping-cap", "best"])
def test_learn_twist_replays_jax(jax_cdf, options):
    obs, emission, spec = _sv_problem()
    key = jax.random.PRNGKey(5)
    options = dict(options)
    num_iterations = options.pop("num_iterations", 2)
    with jax.enable_x64(True):
        want_tw, want_info = jax_twisted.learn_twist(
            jnp.asarray(obs), spec("jax"), emission("jax"), LK, key=key,
            num_iterations=num_iterations, **options)
        want_tw = [np.asarray(v) for v in (want_tw.A, want_tw.b, want_tw.c)]
        want_info = {k: np.asarray(v) for k, v in want_info.items()}
        noise = ReplayNoise(**_learn_draws(
            key, num_iterations, options.get("fit_jitter", 0.0),
            options["keep"], options.get("keep_num_seeds", 1)))
    got_tw, got_info = twisted.learn_twist(
        torch.tensor(obs), spec("torch"), emission("torch"), LK, noise=noise,
        num_iterations=num_iterations, **options)
    assert noise.exhausted()
    for g, w in zip((got_tw.A, got_tw.b, got_tw.c), want_tw):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-8, atol=1e-10)
    assert set(got_info) == set(want_info)
    np.testing.assert_allclose(got_info["log_marginal_likelihood"].numpy(),
                               want_info["log_marginal_likelihood"],
                               rtol=1e-8)
    if options["keep"] == "best":
        np.testing.assert_allclose(got_info["scores"].numpy(),
                                   want_info["scores"], rtol=1e-8)
        np.testing.assert_array_equal(got_info["selected"].numpy(),
                                      want_info["selected"])
    if "max_precision_ratio" in options:
        cap = 2.0 / np.array([0.8 ** 2 / (1 - 0.81)] + [0.8 ** 2] * (LT - 1))
        assert np.all(got_tw.A.numpy() <= cap[:, None] * (1 + 1e-12))


@pytest.mark.parametrize("fit_jitter", [0.0, 1.5])
def test_one_adp_pass_recovers_exact_lgssm_twist(fit_jitter):
    obs = torch.tensor(_lgssm_obs(10, 2, seed=7, dtype=np.float64))
    exact = twisted.exact_lgssm_twist(obs, 0.0, 1.0, A_TR, S_TR, C_EM, S_EM)
    learned, info = twisted.learn_twist(
        obs, _spec("torch"), _emission("torch"), 64, noise=Float64Noise(2),
        num_iterations=1, ridge=0.0, fit_jitter=fit_jitter)
    for name in ("A", "b", "c"):
        np.testing.assert_allclose(getattr(learned, name).numpy(),
                                   getattr(exact, name).numpy(), atol=1e-7)
    assert tuple(info["log_marginal_likelihood"].shape) == (1, 2)
    out = twisted.twisted_smc(obs, _spec("torch"), _emission("torch"),
                              learned, 4, noise=Float64Noise(8))
    np.testing.assert_allclose(out["log_marginal_likelihood"].numpy(),
                               _kalman_loglik(obs.numpy()), atol=1e-7)


def test_damping_mixes_with_the_previous_twist():
    """damping d: the new twist is (1 - d) fitted + d previous; from a
    given init twist and the same draws, the damped twist is the mix of
    the undamped fit and the init."""
    obs = torch.tensor(_lgssm_obs(6, 2, seed=1, dtype=np.float64))
    init = twisted.QuadraticTwist(
        A=torch.full((6, 2), 0.3, dtype=torch.float64),
        b=torch.full((6, 2), -0.2, dtype=torch.float64),
        c=torch.full((6, 2), 0.1, dtype=torch.float64))
    runs = {}
    for d in (0.0, 0.25):
        runs[d], _ = twisted.learn_twist(
            obs, _spec("torch"), _emission("torch"), 32,
            noise=Float64Noise(3), num_iterations=1, init_twist=init,
            damping=d)
    for name in ("A", "b", "c"):
        np.testing.assert_allclose(
            getattr(runs[0.25], name).numpy(),
            (0.75 * getattr(runs[0.0], name)
             + 0.25 * getattr(init, name)).numpy(), rtol=1e-12, atol=1e-12)


# ---- bouncing_ball.gaussian_spec.

BB_T, BB_B, BB_K, BB_PIXELS, BB_HIDDEN = 6, 2, 16, 32, 16


def _bb_models():
    jax_model = jax_bb.make_model(jax.random.PRNGKey(0), num_pixels=BB_PIXELS,
                                  hidden=BB_HIDDEN)
    initial, transition, emission, proposal = jax_model
    params = {
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
    return jax_model, bouncing_ball.from_numpy(params, device="cpu")


def test_gaussian_spec_matches_jax():
    jax_model, port = _bb_models()
    want = jax_bb.gaussian_spec(jax_model[1], jax_model[0])
    got = bouncing_ball.gaussian_spec(port[1], port[0])
    for name in ("initial_loc", "initial_scale", "transition_scale"):
        np.testing.assert_allclose(getattr(got, name).detach().numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-6, err_msg=name)
    x = (np.random.RandomState(0).randn(3, 5, 2) * 2).astype(np.float32)
    np.testing.assert_allclose(got.mean_fn(torch.tensor(x), 1).numpy(),
                               np.asarray(want.mean_fn(jnp.asarray(x), 1)),
                               rtol=1e-6, atol=1e-6)
    assert got.scale_fn is None


def test_bouncing_ball_twisted_run_replays_jax(jax_cdf):
    jax_model, port = _bb_models()
    rng = np.random.RandomState(5)
    pos = rng.rand(BB_T, BB_B)
    obs = (np.asarray(jax_bb.render(jnp.asarray(pos), BB_PIXELS))
           + 0.05 * rng.randn(BB_T, BB_B, BB_PIXELS)).astype(np.float32)
    # A twist pulling the position towards 0.5 and the velocity to 0.
    tw = jax_twisted.QuadraticTwist(
        A=jnp.full((BB_T, BB_B, 2), 4.0), b=jnp.full((BB_T, BB_B, 2), 0.0)
        .at[..., 0].set(2.0), c=jnp.zeros((BB_T, BB_B)))
    key = jax.random.PRNGKey(6)
    kwargs = dict(return_log_weights=True, return_ancestral_indices=True)
    want = jax_twisted.twisted_smc(
        jnp.asarray(obs), jax_bb.gaussian_spec(jax_model[1], jax_model[0]),
        jax_model[2], tw, BB_K, key=key, **kwargs)
    noise = ReplayNoise(**_smc_draws(key, BB_T, BB_B, BB_K, (2,)))
    with torch.no_grad():
        got = twisted.twisted_smc(
            torch.tensor(obs), bouncing_ball.gaussian_spec(port[1], port[0]),
            port[2], _port_twist(tw), BB_K, noise=noise, **kwargs)
    assert noise.exhausted()
    np.testing.assert_array_equal(got["ancestral_indices"].numpy(),
                                  np.asarray(want["ancestral_indices"]))
    for name in ("log_marginal_likelihood", "log_weights", "latents"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   rtol=1e-5, atol=1e-4, err_msg=name)
