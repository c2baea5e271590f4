"""The port's block particle filter (`aesmc_tpu_torch.blockpf`) against the
JAX package's.

Draws are replayed from the JAX key schedule: the prior's normals from
`split(key, (T, 2))[0, 1]`, then at each step the J blocks' resampling
noise from ``fold_in(keys[t, 0], j)`` (``keys[t, 0]`` itself when J = 1),
stacked in block order into the port's one `[J B, ...]` draw, and the
transition's normals from ``keys[t, 1]``; the JAX package's CDF is patched
in so that the ancestors compare exactly. Lorenz-96 at D = 8 (every other
component observed), T = 6, B = 2, K = 64.

Tolerances: ancestors exactly equal; latents, log-weights and log-Z within
1e-5 relative (float32 sums in another order). One block against the
port's own bootstrap `infer` on the same noise at K = 1,024 (where float32
rounding in the weights would move ancestors across bin edges): ancestors,
latents and log-Z bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aesmc_tpu import blockpf as jax_blockpf
from aesmc_tpu import resampling as jax_resampling
from aesmc_tpu import statistics as jax_statistics
from aesmc_tpu.models import lorenz as jax_lorenz
from aesmc_tpu_torch import blockpf, distributions, inference, resampling
from aesmc_tpu_torch.models import lorenz
from aesmc_tpu_torch.noise import NoiseSource
from torch_replay import (PlainSystematic, ReplayNoise, fields, normal_draw,
                          tensor)

D, T, B, K = 8, 6, 2, 64
OBS = tuple(range(0, D, 2))
KEY = jax.random.PRNGKey(4)
CPU = torch.device("cpu")


def _models(dim=D, obs=OBS):
    jax_comps = jax_lorenz.make_model(
        dim=dim, obs_indices=obs, emission_scale=0.5, transition_scale=0.4,
        proposal="bootstrap")
    params = {name: fields(c) for name, c in
              zip(("initial", "transition", "emission"), jax_comps[:3])}
    return jax_comps, lorenz.from_numpy(params, proposal="bootstrap",
                                        device="cpu")


@pytest.fixture(scope="module")
def data():
    jax_comps, _ = _models()
    lat, obs = jax_statistics.sample_from_prior(*jax_comps[:3], T, B,
                                                jax.random.PRNGKey(1))
    return np.asarray(lat), np.asarray(obs)


@pytest.fixture
def jax_cdf(monkeypatch):
    monkeypatch.setattr(resampling, "_normalized_cumsum", lambda lw: tensor(
        jax_resampling._normalized_cumsum(jnp.asarray(lw.detach().numpy()))))


def _resampling_draw(key, method, batch):
    if method == "systematic":
        return "uniforms", np.asarray(jax.random.uniform(key, (batch, 1)))
    if method == "stratified":
        return "uniforms", np.asarray(jax.random.uniform(key, (batch, K)))
    return "exponentials", np.asarray(jax.random.exponential(
        key, (batch, K + 1)))


def _replay(key, num_blocks, method, num_timesteps=T):
    """The block filter's draws from ``key``, in the port's order."""
    keys = jax.random.split(key, (num_timesteps, 2))
    draws = {"uniforms": [], "exponentials": [],
             "normals": [normal_draw(keys[0, 1], (B, K), (D,))]}
    for t in range(1, num_timesteps):
        block_keys = ([keys[t, 0]] if num_blocks == 1 else
                      [jax.random.fold_in(keys[t, 0], j)
                       for j in range(num_blocks)])
        parts = [_resampling_draw(k, method, B) for k in block_keys]
        draws[parts[0][0]].append(np.concatenate([p for _, p in parts]))
        draws["normals"].append(normal_draw(keys[t, 1], (), (B, K, D)))
    return ReplayNoise(**draws)


@pytest.mark.parametrize("blocks,method", [
    (blockpf.contiguous_blocks(D, 4), "systematic"),
    (blockpf.contiguous_blocks(D, 4), "stratified"),
    (blockpf.contiguous_blocks(D, 2), "multinomial"),
    (((0, 2, 4, 6), (1, 3, 5, 7)), "systematic"),
    (((0, 1, 2), (3, 4, 5, 6, 7)), "systematic"),
    (blockpf.contiguous_blocks(D, D), "systematic")])
def test_block_pf_replays_jax(data, jax_cdf, blocks, method):
    jax_comps, comps = _models()
    _, obs = data
    kwargs = dict(obs_indices=OBS, resampling_method=method,
                  return_log_marginal_likelihood=True,
                  return_log_weights=True, return_ancestral_indices=True)
    want = jax_blockpf.block_pf(obs, *jax_comps[:3], K, blocks, key=KEY,
                                **kwargs)
    noise = _replay(KEY, len(blocks), method)
    got = blockpf.block_pf(tensor(obs), *comps[:3], K, blocks, noise=noise,
                           **kwargs)
    assert noise.exhausted()
    assert got["ancestral_indices"].dtype == torch.int32
    np.testing.assert_array_equal(got["ancestral_indices"].numpy(),
                                  np.asarray(want["ancestral_indices"]))
    for name in ("latents", "log_weights", "log_weight",
                 "log_marginal_likelihood"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("remat", [False, True])
def test_one_block_is_the_bootstrap_infer(data, remat):
    _, comps = _models()
    _, obs = data
    got = blockpf.block_pf(
        tensor(obs), *comps[:3], 1024, blockpf.contiguous_blocks(D, D),
        noise=NoiseSource.seeded(7, CPU), obs_indices=OBS, remat=remat,
        return_log_marginal_likelihood=True, return_ancestral_indices=True)
    ref = inference.infer(
        "smc", tensor(obs), *comps, 1024, noise=NoiseSource.seeded(7, CPU),
        return_log_marginal_likelihood=True, return_ancestral_indices=True,
        return_original_latents=True, return_latents=False)
    assert torch.equal(got["ancestral_indices"][:, 0],
                       ref["ancestral_indices"])
    assert torch.equal(got["latents"], ref["original_latents"])
    assert torch.equal(got["log_marginal_likelihood"],
                       ref["log_marginal_likelihood"])


def test_block4_beats_plain_pf_on_lorenz96():
    """tests/test_blockpf.py's oracle on the port: D = 16, T = 20, K = 128,
    three seeds; 4-dimension blocks must halve the plain filter's RMSE."""
    dim, num_timesteps, k = 16, 20, 128
    jax_comps, comps = _models(dim, tuple(range(dim)))
    lat, obs = jax_statistics.sample_from_prior(
        *jax_comps[:3], num_timesteps, 1, jax.random.PRNGKey(3))
    truth = np.asarray(lat)[:, 0]

    def rmse(block_size, seed):
        blocks = blockpf.contiguous_blocks(dim, block_size)
        out = blockpf.block_pf(tensor(obs), *comps[:3], k, blocks,
                               noise=NoiseSource.seeded(seed, CPU),
                               return_log_weights=True)
        m = blockpf.block_filtered_mean(out["latents"], out["log_weights"],
                                        blocks).numpy()[:, 0]
        half = num_timesteps // 2
        return np.sqrt(np.mean((m[half:] - truth[half:]) ** 2))

    plain = np.mean([rmse(dim, s) for s in range(3)])
    local = np.mean([rmse(4, s) for s in range(3)])
    assert local < 0.5 * plain, (local, plain)
    assert local < 1.0, local


def test_block_filtered_mean_matches_jax():
    rng = np.random.RandomState(0)
    latent = rng.randn(3, 2, 5, 7).astype(np.float32)
    logw = rng.randn(3, 2, 5, 3).astype(np.float32)
    blocks = ((0, 3, 6), (1, 4), (2, 5))
    np.testing.assert_allclose(
        blockpf.block_filtered_mean(tensor(latent), tensor(logw),
                                    blocks).numpy(),
        np.asarray(jax_blockpf.block_filtered_mean(latent, logw, blocks)),
        rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("obs_indices,blocks", [
    (OBS, blockpf.contiguous_blocks(D, 4)),
    (OBS, ((0, 1, 2), (3, 4, 5, 6, 7))),
    (tuple(range(D)), ((0, 1, 2), (3, 4, 5, 6, 7))),
    (tuple(range(D)), ((0, 5), (1, 2, 6), (3, 4, 7)))])
def test_local_weights_match_jax(obs_indices, blocks):
    """Every way the port sums the components into blocks: one reshaped sum
    (equal counts, in and out of order) and one sum a block."""
    jax_comps, comps = _models(D, obs_indices)
    rng = np.random.RandomState(1)
    x = (rng.randn(B, K, D) * 2 + 8).astype(np.float32)
    obs = (rng.randn(3, B, len(obs_indices)) + 8).astype(np.float32)
    want = jax_blockpf.diag_emission_local_log_weights(
        jax_comps[2], blocks, obs_indices)(
            [jnp.asarray(x)], 2,
            jax_blockpf._inference.ObservationSequence(obs))
    got = blockpf.diag_emission_local_log_weights(
        comps[2], blocks, obs_indices)(
            [tensor(x)], 2, inference.ObservationSequence(tensor(obs)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


def test_contiguous_blocks_remainder():
    assert blockpf.contiguous_blocks(7, 3) == ((0, 1, 2), (3, 4, 5), (6,))


def test_block_filtered_mean_manual():
    latent = torch.tensor([[[1.0, 2.0, 3.0], [5.0, 6.0, 7.0]]])
    logw = torch.log(torch.tensor([[[0.25, 0.9], [0.75, 0.1]]]))
    m = blockpf.block_filtered_mean(latent, logw, ((0, 1), (2,)))[0]
    np.testing.assert_allclose(
        m.numpy(), [0.25 * 1 + 0.75 * 5, 0.25 * 2 + 0.75 * 6,
                    0.9 * 3 + 0.1 * 7], rtol=1e-6)


def test_shapes_partial_observation_and_one_step(data):
    _, comps = _models()
    _, obs = data
    out = blockpf.block_pf(
        tensor(obs), *comps[:3], 32, blockpf.contiguous_blocks(D, 4),
        noise=NoiseSource.seeded(0, CPU), obs_indices=OBS,
        return_log_marginal_likelihood=True, return_log_weights=True,
        return_ancestral_indices=True)
    assert out["latents"].shape == (T, B, 32, D)
    assert out["log_weights"].shape == (T, B, 32, 2)
    assert out["ancestral_indices"].shape == (T - 1, 2, B, 32)
    assert torch.isfinite(out["log_marginal_likelihood"]).all()
    one = blockpf.block_pf(
        tensor(obs[:1]), *comps[:3], 16, blockpf.contiguous_blocks(D, 4),
        noise=NoiseSource.seeded(0, CPU), obs_indices=OBS,
        return_log_marginal_likelihood=True, return_ancestral_indices=True)
    assert one["log_marginal_likelihood"].shape == (B,)
    assert one["ancestral_indices"].shape == (0, 2, B, 16)


def test_validation_errors(data):
    _, comps = _models()
    _, obs = data
    obs = tensor(obs[:3])
    with pytest.raises(ValueError, match="partition"):
        blockpf.block_pf(obs, *comps[:3], 8, ((0, 1), (2, 3)),
                         noise=NoiseSource.seeded(0, CPU), obs_indices=OBS)
    with pytest.raises(ValueError, match="obs_indices"):
        blockpf.block_pf(obs, *comps[:3], 8, blockpf.contiguous_blocks(D, 4),
                         noise=NoiseSource.seeded(0, CPU),
                         obs_indices=(0, 2))

    class WeirdEmission:
        def __call__(self, latents=None, time=None,
                     previous_observations=None):
            return distributions.Normal(latents[-1][..., 0], 1.0)

    with pytest.raises(TypeError, match="MultivariateNormalDiag"):
        blockpf.block_pf(obs, comps[0], comps[1], WeirdEmission(), 8,
                         blockpf.contiguous_blocks(D, 4),
                         noise=NoiseSource.seeded(0, CPU), obs_indices=OBS)
    # A plain callable draws the [J B, K] indices: the default route's bits.
    plain = PlainSystematic()
    got = blockpf.block_pf(obs, *comps[:3], 8,
                           blockpf.contiguous_blocks(D, 4), obs_indices=OBS,
                           noise=NoiseSource.seeded(0, CPU),
                           return_log_marginal_likelihood=True,
                           resampling_implementation=plain)
    want = blockpf.block_pf(obs, *comps[:3], 8,
                            blockpf.contiguous_blocks(D, 4), obs_indices=OBS,
                            noise=NoiseSource.seeded(0, CPU),
                            return_log_marginal_likelihood=True)
    assert plain.calls == obs.shape[0] - 1
    for name in ("log_marginal_likelihood", "latents"):
        torch.testing.assert_close(got[name], want[name], rtol=0, atol=0)
