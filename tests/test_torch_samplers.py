"""The port's annealed SMC samplers (`aesmc_tpu_torch.samplers`) against the
JAX package's.

Draws are replayed from the JAX key schedule: per rung `key, k =
split(key)`, `k_res, k_move = split(k)`; the resampling noise from
`k_res` (one row's; waste-free: a `()` uniform for systematic, `[M]`
uniforms otherwise), then per sweep `keys = split(kk, L + 1)` over
`split(k_move, num_moves)` (waste-free: `split(k_move, P - 1)`, each
split again into its sweeps): a normal like each particle leaf from
`keys[1:]` (sorted keys) and the accept uniforms from `keys[0]`. The JAX
package's CDF is patched in so that the ancestors compare exactly. The
conjugate-Gaussian target of tests/test_samplers.py at D = 4, K = 256.

Tolerances: rung counts equal; beta histories, log Z, ESS and acceptance
histories and the particles within 1e-5 relative (float32 sums in another
order). The exact-evidence oracles of tests/test_samplers.py on the port,
on that test's replayed draws: log Z within 0.1 (resample-move) and 0.15
(waste-free, both methods) of the exact value over 3 runs at K = 2,048.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aesmc_tpu import resampling as jax_resampling
from aesmc_tpu import samplers as jax_samplers
from aesmc_tpu_torch import resampling, samplers
from aesmc_tpu_torch.noise import NoiseSource
from aesmc_tpu_torch.ops import resample_cuda, searchsorted_sorted_cuda
from torch_replay import PlainSystematic, ReplayNoise, tensor

D, K = 4, 256
S0, S = 2.0, 0.5
KEY = jax.random.PRNGKey(0)
CPU = torch.device("cpu")
Y = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (D,)))


def _problem(lib):
    """Prior N(0, S0^2 I); L(x) = log N(y; x, S^2 I)."""
    if lib == "jax":
        np_, y = jnp, jnp.asarray(Y)
    else:
        np_, y = torch, torch.tensor(Y)
    c0 = D * math.log(S0 * math.sqrt(2 * math.pi))
    c = D * math.log(S * math.sqrt(2 * math.pi))

    def log_prior(x):
        return -0.5 * np_.sum((x / S0) ** 2) - c0

    def log_lik(x):
        return -0.5 * np_.sum(((x - y) / S) ** 2) - c

    return log_prior, log_lik


def _exact_log_z():
    var = S0 ** 2 + S ** 2
    return float(-0.5 * np.sum(Y ** 2) / var - D / 2 * np.log(2 * np.pi * var))


def _x0(k=K, seed=1):
    return np.asarray(S0 * jax.random.normal(jax.random.PRNGKey(seed),
                                             (k, D)))


@pytest.fixture
def jax_cdf(monkeypatch):
    monkeypatch.setattr(resampling, "_normalized_cumsum", lambda lw: tensor(
        jax_resampling._normalized_cumsum(jnp.asarray(lw.detach().numpy()))))


class _Draws:
    """The sampler's draws from the JAX key schedule, rung by rung."""

    def __init__(self, key, shapes, k, num_moves, method, m=None):
        self.key, self.shapes, self.k = key, shapes, k
        self.num_moves, self.method, self.m = num_moves, method, m
        self.draws = {"uniforms": [], "normals": [], "exponentials": []}

    def _sweep(self, kk, n):
        keys = jax.random.split(kk, len(self.shapes) + 1)
        for nk, shape in zip(keys[1:], self.shapes):
            self.draws["normals"].append(np.asarray(
                jax.random.normal(nk, (n,) + shape)))
        self.draws["uniforms"].append(np.asarray(jax.random.uniform(keys[0],
                                                                    (n,))))

    def rung(self):
        self.key, k = jax.random.split(self.key)
        k_res, k_move = jax.random.split(k)
        if self.m is None:
            if self.method == "multinomial":
                self.draws["exponentials"].append(np.asarray(
                    jax.random.exponential(k_res, (1, self.k + 1))))
            else:
                shape = (1, 1) if self.method == "systematic" else (1, self.k)
                self.draws["uniforms"].append(np.asarray(
                    jax.random.uniform(k_res, shape)))
            for kk in jax.random.split(k_move, self.num_moves):
                self._sweep(kk, self.k)
            return
        shape = () if self.method == "systematic" else (self.m,)
        self.draws["uniforms"].append(np.asarray(jax.random.uniform(k_res,
                                                                    shape)))
        for kk in jax.random.split(k_move, self.k // self.m - 1):
            for kkk in jax.random.split(kk, self.num_moves):
                self._sweep(kkk, self.m)

    def noise(self, rungs):
        for _ in range(rungs):
            self.rung()
        return ReplayNoise(**self.draws)


def _compare(got, want, keys=("log_normalizer", "acceptance_rate")):
    assert int(got["num_steps"]) == int(want["num_steps"])
    assert bool(got["reached_final"]) == bool(want["reached_final"])
    for name in keys:
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   rtol=1e-5, atol=1e-6)
    want_p, got_p = want["particles"], got["particles"]
    if isinstance(want_p, dict):
        for name in want_p:
            np.testing.assert_allclose(got_p[name].numpy(),
                                       np.asarray(want_p[name]), rtol=1e-5,
                                       atol=1e-5)
    else:
        np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p),
                                   rtol=1e-5, atol=1e-5)


HISTORY = ("log_normalizer", "acceptance_rate", "beta_history",
           "ess_history", "acceptance_history")


@pytest.mark.parametrize("method,m,num_moves", [
    ("systematic", None, 2), ("stratified", None, 1),
    ("multinomial", 32, 1), ("systematic", 64, 2)])
def test_adaptive_ladder_replays_jax(jax_cdf, method, m, num_moves):
    log_prior, log_lik = _problem("jax")
    kwargs = dict(num_moves=num_moves, step_size=0.4,
                  resampling_method=method, waste_free_chains=m,
                  return_history=True)
    want = jax_samplers.smc_sampler(log_prior, log_lik, _x0(), key=KEY,
                                    **kwargs)
    noise = _Draws(KEY, [(D,)], K, num_moves, method, m).noise(
        int(want["num_steps"]))
    got = samplers.smc_sampler(*_problem("torch"), tensor(_x0()),
                               noise=noise, **kwargs)
    assert noise.exhausted()
    _compare(got, want, HISTORY)


@pytest.mark.parametrize("m", [None, 32])
def test_fixed_ladder_replays_jax(jax_cdf, m):
    betas = np.linspace(0.05, 1.0, 6).astype(np.float32)
    kwargs = dict(num_moves=2, step_size=0.4, betas=betas,
                  waste_free_chains=m, return_history=True,
                  resampling_method="multinomial" if m else "systematic")
    want = jax_samplers.smc_sampler(*_problem("jax"), _x0(), key=KEY,
                                    **kwargs)
    noise = _Draws(KEY, [(D,)], K, 2, kwargs["resampling_method"],
                   m).noise(len(betas))
    got = samplers.smc_sampler(*_problem("torch"), tensor(_x0()),
                               noise=noise, **kwargs)
    assert noise.exhausted()
    _compare(got, want, HISTORY)
    # The same ladder as a float32 tensor.
    noise = _Draws(KEY, [(D,)], K, 2, kwargs["resampling_method"],
                   m).noise(len(betas))
    again = samplers.smc_sampler(*_problem("torch"), tensor(_x0()),
                                 noise=noise, **dict(kwargs,
                                                     betas=tensor(betas)))
    assert torch.equal(again["log_normalizer"], got["log_normalizer"])


def test_dict_particles_and_per_leaf_steps_replay_jax(jax_cdf):
    def jax_prior(p):
        return -0.5 * jnp.sum(p["a"] ** 2) - 0.5 * jnp.sum((p["b"] / 2) ** 2)

    def jax_lik(p):
        return -0.5 * jnp.sum((p["a"] - 1.0) ** 2)

    def prior(p):
        return -0.5 * torch.sum(p["a"] ** 2) - 0.5 * torch.sum(
            (p["b"] / 2) ** 2)

    def lik(p):
        return -0.5 * torch.sum((p["a"] - 1.0) ** 2)

    x0 = {"b": np.asarray(2.0 * jax.random.normal(KEY, (K, 3))),
          "a": np.asarray(jax.random.normal(jax.random.PRNGKey(1), (K, 2)))}
    kwargs = dict(num_moves=2, step_size={"a": 0.3, "b": 0.6},
                  return_history=True)
    want = jax_samplers.smc_sampler(jax_prior, jax_lik, x0, key=KEY,
                                    **kwargs)
    noise = _Draws(KEY, [(2,), (3,)], K, 2, "systematic").noise(
        int(want["num_steps"]))
    got = samplers.smc_sampler(prior, lik, {k: tensor(v) for k, v in
                                            x0.items()}, noise=noise,
                               **kwargs)
    assert noise.exhausted()
    _compare(got, want, HISTORY)


def test_max_steps_forces_completion(jax_cdf):
    kwargs = dict(ess_target=0.99, max_steps=3, return_history=True)
    want = jax_samplers.smc_sampler(*_problem("jax"), _x0(), key=KEY,
                                    **kwargs)
    noise = _Draws(KEY, [(D,)], K, 3, "systematic").noise(3)
    got = samplers.smc_sampler(*_problem("torch"), tensor(_x0()),
                               noise=noise, **kwargs)
    assert int(got["num_steps"]) == 3 and not bool(got["reached_final"])
    assert float(got["beta_history"][-1]) == 1.0
    _compare(got, want, HISTORY)


def test_num_moves_zero_is_annealed_importance_sampling():
    out = samplers.smc_sampler(*_problem("torch"), tensor(_x0()),
                               noise=NoiseSource.seeded(0, CPU), num_moves=0)
    assert float(out["acceptance_rate"]) == 0.0
    assert torch.isfinite(out["log_normalizer"])


@pytest.mark.parametrize("m,method,tol", [
    (None, "systematic", 0.1), (64, "multinomial", 0.15),
    (64, "systematic", 0.15)])
def test_evidence_against_exact(jax_cdf, m, method, tol):
    """tests/test_samplers.py's oracle on the port, with that test's own
    draws (keys 0, 1, 2) replayed: K = 2,048, the mean log Z of 3 runs
    within ``tol`` of the exact value. (On the port's own noise the 3-run
    mean is as noisy as on the JAX package's: its Jensen bias is about
    -0.055 at K = 2,048 in both, with a spread of 0.04 for a 3-run mean.)"""
    x0 = _x0(2048)
    kwargs = dict(num_moves=4 if m is None else 1, step_size=0.4,
                  waste_free_chains=m, resampling_method=method)
    lzs = []
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        rungs = int(jax_samplers.smc_sampler(*_problem("jax"), x0, key=key,
                                             **kwargs)["num_steps"])
        noise = _Draws(key, [(D,)], 2048, kwargs["num_moves"], method,
                       m).noise(rungs)
        out = samplers.smc_sampler(*_problem("torch"), tensor(x0),
                                   noise=noise, **kwargs)
        assert noise.exhausted()
        lzs.append(float(out["log_normalizer"]))
    assert abs(np.mean(lzs) - _exact_log_z()) < tol, (lzs, _exact_log_z())


def test_kernel_routes(monkeypatch):
    """With the 'cuda' route (patched in on CPU tensors, where the wrappers
    run their plain versions) a resample-move rung calls K1's wrapper once
    and a waste-free rung K4's once."""
    calls = {"k1": 0, "k4": 0}
    k1, k4 = (resample_cuda.resample_and_gather_systematic,
              searchsorted_sorted_cuda.searchsorted_sorted)

    def count(name, fn):
        def wrapped(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(resampling, "_route", lambda device, impl: "cuda")
    monkeypatch.setattr(resample_cuda, "resample_and_gather_systematic",
                        count("k1", k1))
    monkeypatch.setattr(searchsorted_sorted_cuda, "searchsorted_sorted",
                        count("k4", k4))
    out = samplers.smc_sampler(*_problem("torch"), tensor(_x0()),
                               noise=NoiseSource.seeded(0, CPU), num_moves=1)
    assert calls == {"k1": int(out["num_steps"]), "k4": 0}
    calls["k1"] = 0
    out = samplers.smc_sampler(*_problem("torch"), tensor(_x0()),
                               noise=NoiseSource.seeded(0, CPU), num_moves=1,
                               waste_free_chains=32,
                               resampling_method="multinomial")
    assert calls == {"k1": 0, "k4": int(out["num_steps"])}


def test_validation_errors():
    args = _problem("torch")
    x0 = torch.zeros((32, 2))
    with pytest.raises(ValueError, match="ess_target"):
        samplers.smc_sampler(*args, x0, ess_target=1.5)
    with pytest.raises(ValueError, match="num_moves"):
        samplers.smc_sampler(*args, x0, num_moves=-1)
    with pytest.raises(ValueError, match="divide"):
        samplers.smc_sampler(*args, x0, waste_free_chains=7)
    with pytest.raises(ValueError, match="1 <= M < K"):
        samplers.smc_sampler(*args, x0, waste_free_chains=32)
    with pytest.raises(ValueError, match="num_moves"):
        samplers.smc_sampler(*args, x0, waste_free_chains=8, num_moves=0)
    # A plain callable passes through: the bits of the default route.
    plain = PlainSystematic()
    x0 = torch.randn((32, D), generator=torch.Generator().manual_seed(0))
    got = samplers.smc_sampler(*args, x0, noise=NoiseSource.seeded(0, "cpu"),
                               resampling_implementation=plain)
    want = samplers.smc_sampler(*args, x0,
                                noise=NoiseSource.seeded(0, "cpu"))
    assert plain.calls == int(want["num_steps"])
    for name in ("log_normalizer", "particles"):
        torch.testing.assert_close(got[name], want[name], rtol=0, atol=0)


@pytest.mark.parametrize("k", [1, 2, 511, 513, 4096, 262144])
def test_two_level_cumsum_of_one_row(k):
    """The sampler's one row of weights is scanned in two levels on the card
    (`resampling._row_cumsum`: PyTorch's one-row scan there varies from run
    to run): within 1e-6 of the float64 cumulative sum, relative to the
    total. On the CPU `_row_cumsum` is `torch.cumsum` itself."""
    x = torch.rand(1, k, generator=torch.Generator().manual_seed(k))
    got = resampling._two_level_cumsum(x)
    want = torch.cumsum(x.double(), dim=-1)
    assert got.shape == (1, k) and got.dtype == torch.float32
    assert float((got.double() - want).abs().max() / want[0, -1]) < 1e-6
    assert torch.equal(resampling._row_cumsum(x), torch.cumsum(x, dim=-1))
