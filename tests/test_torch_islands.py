"""The port's island SMC (`aesmc_tpu_torch.parallel.island_infer`)
against the JAX package's (`tests/test_islands.py`).

Island i of the port draws from ``noise.fold_in(i)``, the island-level
resampling from ``noise.fold_in(0x15AD)``; here those sources replay the
JAX run's draws from ``fold_in(KEY, i)`` (split as `aesmc_tpu.inference.
infer` splits a key) and from ``split(fold_in(KEY, 0x15AD), T)``. The
three exact reductions of the JAX tests hold against the JAX package, and
a 4-rank ('island',) gloo mesh on the CPU (`torch_dist`) gives the
single-device result. The unbiasedness test against Kalman's evidence
runs on the card (`chip_smoke.py`, phase 35).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist
import torch_threads  # noqa: F401
from aesmc_tpu import inference as jax_inference
from aesmc_tpu.models import lgssm as jax_lgssm
from aesmc_tpu.parallel import islands as jax_islands
from aesmc_tpu_torch import inference, parallel
from aesmc_tpu_torch.noise import NoiseSource
from torch_replay import lgssm_params, normal_draw

KEY = jax.random.PRNGKey(42)
A, Q_SCALE = 0.9, 1.0
C, R_SCALE = 1.0, 2.0


def _jax_components():
    """The bootstrap LGSSM of the JAX tests."""
    return (jax_lgssm.Initial(0.0, 1.0),
            jax_lgssm.Transition.create(A, Q_SCALE),
            jax_lgssm.Emission.create(C, R_SCALE),
            jax_lgssm.Proposal(
                lin_0_weight=jnp.asarray(0.0), lin_0_bias=jnp.asarray(0.0),
                lin_t_weight=jnp.asarray([A, 0.0]),
                lin_t_bias=jnp.asarray(0.0), scale_0=1.0, scale_t=Q_SCALE))


PARAMS = lgssm_params(_jax_components())


def _components():
    return torch_dist.lgssm_components(PARAMS)


def _model_observations(T, B, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(0.0, 1.0, size=B)
    ys = []
    for t in range(T):
        if t > 0:
            x = A * x + rng.normal(0.0, Q_SCALE, size=B)
        ys.append(C * x + rng.normal(0.0, R_SCALE, size=B))
    return np.stack(ys).astype(np.float32)


def _infer_draws(key, T, B, K):
    """`infer`'s draws from ``key`` (systematic resampling)."""
    keys = jax.random.split(key, (T, 2))
    normals = [normal_draw(keys[0, 1], (K,), (B,), batch_expanded=True)]
    normals += [normal_draw(keys[t, 1], (), (B, K)) for t in range(1, T)]
    uniforms = [np.asarray(jax.random.uniform(keys[t, 0], (B, 1),
                                              dtype=jnp.float32))
                for t in range(1, T)]
    return {"normal": normals, "uniform": uniforms}


class FoldReplay:
    """A source whose ``fold_in(i)`` replays the JAX island run's draws."""

    device = torch.device("cpu")

    def __init__(self, T, B, K):
        self.shape = (T, B, K)

    def fold_in(self, i):
        T, B, K = self.shape
        if i == parallel.islands.ISLAND_STREAM:
            keys = jax.random.split(
                jax.random.fold_in(KEY, jnp.uint32(i)), T)
            return torch_dist.ListNoise(uniform=[
                np.asarray(jax.random.uniform(keys[t], (B, 1),
                                              dtype=jnp.float32))
                for t in range(1, T)])
        return torch_dist.ListNoise(**_infer_draws(
            jax.random.fold_in(KEY, jnp.uint32(i)), T, B, K))


def _numpy(x):
    return x.detach().numpy()


class TestExactReductions:
    def test_never_is_logmeanexp_of_independent_filters(self):
        T, B, K, N = 6, 2, 8, 3
        obs = _model_observations(T, B)
        want = jax_islands.island_infer(
            obs, *_jax_components(), num_particles=K, num_islands=N,
            key=KEY, island_resampling_criterion="never")
        out = parallel.island_infer(
            torch.tensor(obs), *_components(), num_particles=K,
            num_islands=N, noise=FoldReplay(T, B, K),
            island_resampling_criterion="never")
        np.testing.assert_allclose(
            _numpy(out["log_marginal_likelihood"]),
            np.asarray(want["log_marginal_likelihood"]), atol=1e-4)
        np.testing.assert_allclose(
            _numpy(out["island_log_marginal_likelihood"]),
            np.asarray(want["island_log_marginal_likelihood"]), atol=1e-4)
        assert np.all(_numpy(out["num_island_events"]) == 0)
        # Each island is the port's own infer on its stream, bit for bit.
        per_island = torch.stack([inference.infer(
            "smc", torch.tensor(obs), *_components(), K,
            noise=FoldReplay(T, B, K).fold_in(i),
            return_log_marginal_likelihood=True,
            return_latents=False)["log_marginal_likelihood"]
            for i in range(N)])
        np.testing.assert_array_equal(
            _numpy(out["island_log_marginal_likelihood"]),
            _numpy(per_island))
        np.testing.assert_array_equal(
            _numpy(out["log_marginal_likelihood"]),
            _numpy(torch.logsumexp(per_island, dim=0) - np.log(N)))

    def test_single_island_matches_infer(self):
        T, B, K = 5, 3, 16
        obs = _model_observations(T, B, seed=1)
        out = parallel.island_infer(
            torch.tensor(obs), *_components(), num_particles=K,
            num_islands=1, noise=FoldReplay(T, B, K))
        want = jax_inference.infer(
            "smc", obs, *_jax_components(), K,
            key=jax.random.fold_in(KEY, jnp.uint32(0)),
            return_log_marginal_likelihood=True, return_latents=False)
        np.testing.assert_allclose(
            _numpy(out["log_marginal_likelihood"]),
            np.asarray(want["log_marginal_likelihood"]), atol=1e-4)

    def test_always_counts_every_step(self):
        T, B, K, N = 5, 2, 8, 4
        obs = _model_observations(T, B, seed=2)
        want = jax_islands.island_infer(
            obs, *_jax_components(), num_particles=K, num_islands=N,
            key=KEY, island_resampling_criterion="always")
        out = parallel.island_infer(
            torch.tensor(obs), *_components(), num_particles=K,
            num_islands=N, noise=FoldReplay(T, B, K),
            island_resampling_criterion="always")
        assert np.all(_numpy(out["num_island_events"]) == T - 1)
        np.testing.assert_allclose(
            _numpy(out["log_marginal_likelihood"]),
            np.asarray(want["log_marginal_likelihood"]), atol=1e-4)
        np.testing.assert_allclose(
            _numpy(out["pooled_log_weight"]),
            np.asarray(want["pooled_log_weight"]), atol=1e-4)

    def test_validation(self):
        obs = torch.tensor(_model_observations(3, 1))
        with pytest.raises(ValueError, match="num_islands"):
            parallel.island_infer(obs, *_components(), num_particles=4,
                                  num_islands=0)
        with pytest.raises(ValueError, match="criterion"):
            parallel.island_infer(obs, *_components(), num_particles=4,
                                  num_islands=2,
                                  island_resampling_criterion=1.5)


MESH_OBS = _model_observations(6, 2, seed=6)
MESH_CASES = {crit: ("island_case", dict(
    n_ranks=4, obs=MESH_OBS, params=PARAMS, num_particles=8, num_islands=8,
    criterion=crit)) for crit in (0.5, "always", "never")}
MESH_CASES["bad_axis"] = ("island_bad_axis", dict(n_ranks=4, obs=MESH_OBS,
                                                  params=PARAMS))


@pytest.fixture(scope="module")
def world():
    names = list(MESH_CASES)
    return dict(zip(names, torch_dist.run_world(
        4, [MESH_CASES[n] for n in names])))


class TestMesh:
    @pytest.mark.parametrize("criterion", [0.5, "always", "never"])
    def test_island_mesh_equals_single_device(self, world, criterion):
        results = world[criterion]
        plain = parallel.island_infer(
            torch.tensor(MESH_OBS), *_components(), num_particles=8,
            num_islands=8, noise=NoiseSource.seeded(0, "cpu"),
            island_resampling_criterion=criterion)
        for key in ("log_marginal_likelihood",
                    "island_log_marginal_likelihood", "num_island_events"):
            for r in results:
                np.testing.assert_array_equal(r[key], _numpy(plain[key]),
                                              err_msg=key)
        for key in ("log_weight", "pooled_log_weight", "last_latent"):
            np.testing.assert_array_equal(
                np.concatenate([r[key] for r in results]),
                _numpy(plain[key]), err_msg=key)

    def test_bad_island_axis_raises(self, world):
        message = world["bad_axis"][0]
        assert message is not None and "island_axis" in message
