"""The port's SQMC (`aesmc_tpu_torch.sqmc`) against the JAX package's.

The Sobol scrambles replay the JAX draws: `jax.random.bits` of the
`split(key)` pair of each scramble, handed to the port through
`NoiseSource.bits` as int64 words; `sqmc_infer` replays
`split(key, (T, B))[t, b]` a row and step. Tolerances: direction numbers,
Sobol words and points, the scramble and the Hilbert keys and orders are
exactly equal (integer arithmetic; float32 points are the top 24 bits of
the same words); `quantile_sample` within 1e-6 (`ndtri` of two
libraries); `sqmc_infer` ancestors exactly equal, latents within 1e-5
absolute and log-Z within 1e-5 relative, at (T, B, K) = (8, 2, 64) on the
LGSSM and (6, 2, 128) on a 2-d latent (two-word Hilbert keys at bits =
16); the 'cuda' route (K3's wrapper on CPU tensors runs its plain
version) gives the same ancestors as the 'torch' route.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aesmc_tpu import distributions as jax_dists
from aesmc_tpu import sqmc as jax_sqmc
from aesmc_tpu import state as jax_state
from aesmc_tpu import statistics as jax_statistics
from aesmc_tpu.models import lgssm as jax_lgssm
from aesmc_tpu_torch import distributions, resampling, sqmc, state
from aesmc_tpu_torch.models import lgssm
from aesmc_tpu_torch.ops import resample_sorted_cuda
from torch_replay import ReplayNoise, lgssm_params, tensor

CPU = "cpu"
KEY = jax.random.PRNGKey(3)


def _scramble_bits(key, dim):
    """The JAX draws of one scramble: (matrix words `[dim, 32]`, shift
    words `[dim]`), uint32."""
    k_lms, k_shift = jax.random.split(key)
    return (np.asarray(jax.random.bits(k_lms, (dim, 32), jnp.uint32)),
            np.asarray(jax.random.bits(k_shift, (dim,), jnp.uint32)))


def _filter_bits(key, num_timesteps, batch, d0):
    """`sqmc_infer`'s draws from ``key``: per step `[B, dim, 32]` then
    `[B, dim]`, row b from `split(key, (T, B))[t, b]`."""
    step_keys = jax.random.split(key, (num_timesteps, batch))
    draws = []
    for t in range(num_timesteps):
        dim = d0 if t == 0 else 1 + d0
        rows = [_scramble_bits(step_keys[t, b], dim) for b in range(batch)]
        draws += [np.stack([r[0] for r in rows]),
                  np.stack([r[1] for r in rows])]
    return draws


@pytest.mark.parametrize("dim", [1, 2, 64, 70])
def test_direction_numbers_equal_jax(dim):
    got = sqmc.direction_numbers(dim)
    assert got.dtype == np.uint32 and got.shape == (dim, 32)
    np.testing.assert_array_equal(got, jax_sqmc.direction_numbers(dim))


@pytest.mark.parametrize("num_points,dim", [(256, 1), (100, 3), (37, 70)])
def test_sobol_points_bit_equal_jax(num_points, dim):
    rnd, shift = _scramble_bits(KEY, dim)
    points = sqmc.sobol_points(num_points, dim,
                               ReplayNoise(bits=[rnd, shift]))
    assert points.dtype == torch.float32
    np.testing.assert_array_equal(
        points.numpy(),
        np.asarray(jax_sqmc.sobol_points(num_points, dim, key=KEY)))


def test_sobol_words_and_raw_sequence_equal_jax():
    """All 32 bits of the scrambled words, and the unscrambled
    sequence."""
    rnd, shift = _scramble_bits(KEY, 3)
    words = sqmc._sobol_uint32(100, 3, ReplayNoise(bits=[rnd, shift]))
    np.testing.assert_array_equal(
        words.numpy(), np.asarray(jax_sqmc._sobol_uint32(100, 3, key=KEY)))
    raw = sqmc.sobol_points(100, 3, scramble=False, device=CPU)
    np.testing.assert_array_equal(
        raw.numpy(), np.asarray(jax_sqmc.sobol_points(100, 3,
                                                      scramble=False)))


def test_lms_scramble_bit_equal_jax_and_identity():
    dim = 5
    v = np.asarray(jax_sqmc.direction_numbers(dim))
    k_lms = jax.random.split(KEY)[0]
    rnd = np.asarray(jax.random.bits(k_lms, (dim, 32), jnp.uint32))
    v_t = torch.tensor(v.astype(np.int64))
    got = sqmc._lms_scramble(v_t, torch.tensor(rnd.astype(np.int64)))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_sqmc._lms_scramble(jnp.asarray(v),
                                                       k_lms)))
    # Zero random words leave the identity matrix: a no-op.
    np.testing.assert_array_equal(
        sqmc._lms_scramble(v_t, torch.zeros((dim, 32), dtype=torch.int64)),
        v_t)
    with pytest.raises(ValueError, match="noise source"):
        sqmc.sobol_points(8, 2)


@pytest.mark.parametrize("d,bits", [(2, 16), (3, 8), (2, 10), (4, 15)])
def test_hilbert_index_equal_jax(d, bits):
    coords = np.random.default_rng(d * bits).integers(0, 2 ** bits,
                                                      (4, 40, d))
    got = sqmc.hilbert_index(torch.tensor(coords), bits)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_sqmc.hilbert_index(jnp.asarray(coords),
                                                       bits)))
    with pytest.raises(ValueError, match="62"):
        sqmc.hilbert_index(torch.zeros((2, 3), dtype=torch.int64), 32)


@pytest.mark.parametrize("shape,bits", [
    ((3, 200), None), ((3, 200, 2), None), ((3, 200, 2), 15),
    ((3, 200, 3), None), ((2, 100, 5), 6)])
def test_hilbert_sort_indices_equal_jax(shape, bits):
    """Including ties (rounded values) and the two-word keys (d * bits >
    31: (2, 16) by default, (3, 20))."""
    x = np.round(np.random.default_rng(len(shape)).normal(size=shape),
                 1).astype(np.float32)
    got = sqmc.hilbert_sort_indices(torch.tensor(x), bits)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_sqmc.hilbert_sort_indices(
            jnp.asarray(x), bits)))


class _Uniforms:
    """A distribution with its own quantile transform."""

    batch_shape_mode = state.BatchShapeMode.FULLY_EXPANDED
    batch_shape = (2, 6)
    event_shape = (1,)

    def sample_from_uniforms(self, u):
        return u * 2.0


def _families(lib, dists_mod, arr):
    rng = np.random.default_rng(0)
    loc_b = arr(rng.normal(size=(2,)).astype(np.float32))
    loc_bk3 = arr(rng.normal(size=(2, 6, 3)).astype(np.float32))
    scale3 = arr(rng.uniform(0.5, 2.0, size=(3,)).astype(np.float32))
    tril = arr(np.tril(rng.normal(size=(3, 3))).astype(np.float32) +
               3.0 * np.eye(3, dtype=np.float32))
    mode = (jax_state if lib == "jax" else state).BatchShapeMode
    return {
        "normal_not_expanded": dists_mod.Normal(0.5, 2.0),
        "normal_batch_expanded": dists_mod.Normal(
            loc_b, 0.7, batch_shape_mode=mode.BATCH_EXPANDED),
        "mvn_diag": dists_mod.MultivariateNormalDiag(
            loc_bk3, scale3, batch_shape_mode=mode.FULLY_EXPANDED),
        "mvn_tril": dists_mod.MultivariateNormalTriL(
            loc_bk3, tril, batch_shape_mode=mode.FULLY_EXPANDED),
        "independent": dists_mod.Independent(
            dists_mod.Normal(loc_bk3, scale3), 1,
            batch_shape_mode=mode.FULLY_EXPANDED),
        "deterministic": dists_mod.Deterministic(loc_bk3, event_ndims=1),
    }


@pytest.mark.parametrize("family", [
    "normal_not_expanded", "normal_batch_expanded", "mvn_diag", "mvn_tril",
    "independent", "deterministic"])
def test_quantile_sample_matches_jax(family):
    port = _families("torch", distributions, torch.tensor)[family]
    ref = _families("jax", jax_dists, jnp.asarray)[family]
    d = max(sqmc.event_size(port), 1)
    assert sqmc.event_size(port) == jax_sqmc.event_size(ref)
    u = np.random.default_rng(1).uniform(size=(2, 6, d)).astype(np.float32)
    u[0, 0] = 0.0           # the clip's ends
    u[1, 0] = 1.0 - 2.0 ** -24
    got = sqmc.quantile_sample(port, 2, 6, torch.tensor(u))
    want = np.asarray(jax_sqmc.quantile_sample(ref, 2, 6, jnp.asarray(u)))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_quantile_sample_duck_type_and_errors():
    u = torch.full((2, 6, 1), 0.25)
    np.testing.assert_array_equal(
        sqmc.quantile_sample(_Uniforms(), 2, 6, u).numpy(), 0.5)
    with pytest.raises(TypeError, match="quantile transform"):
        sqmc.quantile_sample(distributions.Bernoulli(torch.zeros(2, 6)),
                             2, 6, u)
    with pytest.raises(TypeError, match=r"Independent\(Normal, 1\) only"):
        sqmc.quantile_sample(distributions.Independent(
            distributions.Laplace(torch.zeros(2, 6, 3), 1.0), 1), 2, 6,
            torch.full((2, 6, 3), 0.25))


# ---------------------------------------------------------------------
# sqmc_infer against the JAX filter.
# ---------------------------------------------------------------------

T1, B1, K1 = 8, 2, 64
T2, B2, K2 = 6, 2, 128
_A = np.array([[0.9, 0.2], [-0.1, 0.8]], np.float32)
_TRIL = np.array([[0.6, 0.0], [0.2, 0.5]], np.float32)


def _model_2d(lib):
    """A 2-d latent model written for either package: MVN-diagonal prior,
    transition and emission, and an MVN-TriL proposal (the quantile
    transform's einsum)."""
    if lib == "jax":
        d, arr, mode = jax_dists, jnp.asarray, jax_state.BatchShapeMode
    else:
        d, arr, mode = distributions, torch.tensor, state.BatchShapeMode
    a, tril = arr(_A), arr(_TRIL)

    def initial():
        return d.MultivariateNormalDiag(arr(np.zeros(2, np.float32)),
                                        arr(np.ones(2, np.float32)))

    def transition(previous_latents=None, time=None,
                   previous_observations=None):
        return d.MultivariateNormalDiag(
            previous_latents[-1] @ a.T, arr(np.ones(2, np.float32)),
            batch_shape_mode=mode.FULLY_EXPANDED)

    def emission(latents=None, time=None, previous_observations=None):
        return d.MultivariateNormalDiag(
            latents[-1], arr(np.full(2, 0.5, np.float32)),
            batch_shape_mode=mode.FULLY_EXPANDED)

    def proposal(previous_latents=None, time=None, observations=None):
        if time == 0:
            return d.MultivariateNormalTriL(
                0.8 * observations[0], tril,
                batch_shape_mode=mode.BATCH_EXPANDED)
        loc = (0.5 * previous_latents[-1] @ a.T +
               0.5 * observations[time][:, None, :])
        return d.MultivariateNormalTriL(
            loc, tril, batch_shape_mode=mode.FULLY_EXPANDED)

    return initial, transition, emission, proposal


def _lgssm_models():
    jax_comps = (jax_lgssm.Initial(0.0, 1.0),
                 jax_lgssm.Transition.create(0.9, 1.0),
                 jax_lgssm.Emission.create(1.0, 0.5),
                 jax_lgssm.Proposal.create(0.8, 0.7, jax.random.PRNGKey(1)))
    comps = lgssm.from_numpy(lgssm_params(jax_comps), device=CPU)
    return jax_comps, comps


_OUTPUTS = dict(return_log_marginal_likelihood=True,
                return_ancestral_indices=True, return_original_latents=True)


@pytest.fixture(scope="module")
def reference():
    """The JAX runs, once: (model, obs, key, JAX output) for 'lgssm' and
    '2d'."""
    jax_comps, _ = _lgssm_models()
    _, obs1 = jax_statistics.sample_from_prior(*jax_comps[:3], T1, B1,
                                               jax.random.PRNGKey(2))
    comps2 = _model_2d("jax")
    _, obs2 = jax_statistics.sample_from_prior(*comps2[:3], T2, B2,
                                               jax.random.PRNGKey(4))
    key1, key2 = jax.random.PRNGKey(5), jax.random.PRNGKey(6)
    # One jitted program each compiles faster than the scan op by op.
    run1 = jax.jit(lambda o, k: jax_sqmc.sqmc_infer(
        o, *jax_comps, K1, key=k, **_OUTPUTS))
    run2 = jax.jit(lambda o, k: jax_sqmc.sqmc_infer(
        o, *comps2, K2, key=k, hilbert_bits=16, **_OUTPUTS))
    return {"lgssm": (np.asarray(obs1), key1, 1, K1, run1(obs1, key1)),
            "2d": (np.asarray(obs2), key2, 2, K2, run2(obs2, key2))}


def _port_run(name, reference, route):
    obs, key, d0, k, _ = reference[name]
    comps = (_lgssm_models()[1] if name == "lgssm" else _model_2d("torch"))
    noise = ReplayNoise(bits=_filter_bits(key, obs.shape[0], obs.shape[1],
                                          d0))
    out = sqmc.sqmc_infer(tensor(obs), *comps, k, noise=noise,
                          hilbert_bits=None if name == "lgssm" else 16,
                          **_OUTPUTS)
    assert noise.exhausted()
    return out


@pytest.mark.parametrize("name", ["lgssm", "2d"])
def test_sqmc_infer_matches_jax(name, reference):
    want = reference[name][-1]
    out = _port_run(name, reference, "torch")
    np.testing.assert_array_equal(out["ancestral_indices"].numpy(),
                                  np.asarray(want["ancestral_indices"]))
    np.testing.assert_allclose(out["original_latents"].detach().numpy(),
                               np.asarray(want["original_latents"]),
                               atol=1e-5)
    np.testing.assert_allclose(
        out["log_marginal_likelihood"].detach().numpy(),
        np.asarray(want["log_marginal_likelihood"]), rtol=1e-5)


@pytest.mark.parametrize("name", ["lgssm", "2d"])
def test_cuda_route_gives_the_same_ancestors(name, reference, monkeypatch):
    """The 'cuda' route's wrapper (K3, here its plain version on CPU
    tensors), once a step, with no index output: the gathered permutation
    column is the ancestor, equal to the 'torch' route's search."""
    calls = []
    launch = resample_sorted_cuda.resample_and_gather_sorted

    def spy(cdf, pos, value, emit_idx=True):
        calls.append((tuple(value.shape), emit_idx))
        return launch(cdf, pos, value, emit_idx)

    want = _port_run(name, reference, "torch")
    monkeypatch.setattr(resampling, "resolve_implementation",
                        lambda *args: "cuda")
    monkeypatch.setattr(resample_sorted_cuda, "resample_and_gather_sorted",
                        spy)
    got = _port_run(name, reference, "cuda")
    obs, _, _, k, _ = reference[name]
    assert calls == [((obs.shape[1], k, 1), False)] * (obs.shape[0] - 1)
    np.testing.assert_array_equal(got["ancestral_indices"].numpy(),
                                  want["ancestral_indices"].numpy())
    assert torch.equal(got["log_marginal_likelihood"],
                       want["log_marginal_likelihood"])


def test_sqmc_errors_and_the_large_k_limit(monkeypatch):
    _, comps = _lgssm_models()
    obs = torch.zeros(3, 1)
    with pytest.raises(ValueError, match="Hilbert inverse-CDF"):
        sqmc.sqmc_infer(obs, *comps, 8, noise=ReplayNoise(bits=[
            np.zeros((1, 1, 32), np.uint32), np.zeros((1, 1), np.uint32)]),
            resampling_implementation=lambda *a: None)

    # The kernel route holds up to K = 2^24 (the float32 permutation
    # column is exact there; the JAX package's 2^21 switch is not ported)
    # and raises above it, for 'cuda' and for 'auto' on the card alike:
    # it never switches to the torch route on its own.
    monkeypatch.setattr(resampling, "resolve_implementation",
                        lambda *args: "cuda")
    for implementation in ("cuda", "auto"):
        with pytest.raises(ValueError, match="2\\^24"):
            sqmc._check_implementation(CPU, (1 << 24) + 1, implementation)
        assert sqmc._check_implementation(CPU, 1 << 24, implementation)
        assert sqmc._check_implementation(CPU, (1 << 21) + 1,
                                          implementation)
    monkeypatch.setattr(resampling, "resolve_implementation",
                        lambda *args: "torch")
    assert not sqmc._check_implementation(CPU, (1 << 24) + 1, "torch")


def test_unscrambled_filter_and_single_step():
    """scramble=False draws nothing; T = 1 returns the t = 0 weights and
    an empty `[0, B, K]` ancestor stack."""
    _, comps = _lgssm_models()
    obs = torch.tensor(np.random.default_rng(0).normal(
        size=(1, 3)).astype(np.float32))
    out = sqmc.sqmc_infer(obs, *comps, 16, noise=ReplayNoise(),
                          scramble=False, return_ancestral_indices=True,
                          return_log_marginal_likelihood=True)
    assert out["ancestral_indices"].shape == (0, 3, 16)
    assert out["latents"].shape == (1, 3, 16)
    assert torch.isfinite(out["log_marginal_likelihood"]).all()


def test_remat_gives_the_same_log_z_and_gradients(reference):
    """`remat=True` recomputes each step on the backward pass from the
    step's recorded draws: the same log-Z and gradients (exactly: the
    same operations on the same inputs)."""
    obs, key, d0, k, _ = reference["lgssm"]
    results = []
    for remat in (False, True):
        comps = _lgssm_models()[1]
        noise = ReplayNoise(bits=_filter_bits(key, obs.shape[0],
                                              obs.shape[1], d0))
        out = sqmc.sqmc_infer(tensor(obs), *comps, k, noise=noise,
                              remat=remat, return_latents=False,
                              return_log_marginal_likelihood=True)
        log_z = out["log_marginal_likelihood"]
        params = [p for c in comps for p in c.parameters()]
        grads = torch.autograd.grad(log_z.sum(), params)
        results.append((log_z.detach(), grads))
    (z0, g0), (z1, g1) = results
    assert torch.equal(z0, z1)
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)
