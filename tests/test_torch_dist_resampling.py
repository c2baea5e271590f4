"""The port's distributed resampling against the JAX package's.

The port runs on an 8-rank gloo world on the CPU (`torch_dist`, one
world for the whole file), the JAX package on its 8 fake CPU devices, on
the same seeded numpy inputs; the port replays the JAX draws (`u`, the
stratified uniforms, the exponential spacings), which both packages draw
over the GLOBAL grid. Mirrors `tests/test_parallel.py`: indices and
redistribution exact, the fused all-gather exchange exact, the ring equal
to the all-gather exchange and to one device bit for bit (also with all
the mass on one shard), the methods x exchanges exact, soft resampling
(gradients within the JAX test's 1e-5). The JAX package's own tests hold
its mesh resamplers equal to its single-device ones at these sizes: here
every mesh of the port is held against the JAX single-device functions,
and the (2, 4) mesh also against the JAX mesh resamplers (each JAX mesh
program compiles for seconds, so the file keeps to four of them). At
these sizes the two packages' CDFs (each its own float order) put no
position in another bin, so no JAX CDF is patched in. A spy on
`collectives.all_gather` is the port's form of
`test_ring_memory_is_sublinear`: the ring gathers no `[B, K]` tensor,
only the n shard sums.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist
import torch_threads  # noqa: F401
from aesmc_tpu import parallel as jax_parallel
from aesmc_tpu import resampling as jax_resampling
from aesmc_tpu import state as jax_state
from aesmc_tpu_torch import parallel, resampling

KEY = jax.random.PRNGKey(3)
MESHES = [(2, 4), (1, 8), (4, 2), (8, 1)]
ALPHA = 0.5


def _draws(method, batch, k):
    """The JAX draws of ``method`` from KEY, as `torch_dist.ListNoise`
    kinds."""
    if method == "systematic":
        return {"uniform": [np.asarray(jax.random.uniform(
            KEY, (batch, 1), dtype=jnp.float32))]}
    if method == "stratified":
        return {"uniform": [np.asarray(jax.random.uniform(
            KEY, (batch, k), dtype=jnp.float32))]}
    return {"exponential": [np.asarray(jax.random.exponential(
        KEY, (batch, k + 1), dtype=jnp.float32))]}


def _lw(seed, batch, k):
    return np.random.RandomState(seed).randn(batch, k).astype(np.float32)


LW = _lw(0, 8, 32)
LW_SMALL = _lw(0, 4, 16)
LATENT = np.random.RandomState(1).randn(4, 16, 3).astype(np.float32)
_rng = np.random.RandomState(7)
LW_RING = _rng.randn(8, 32).astype(np.float32)
VALUE_RING = {"x": _rng.randn(8, 32).astype(np.float32),
              "y": _rng.randn(8, 32, 2).astype(np.float32)}
_rng = np.random.RandomState(1)
LW_VAR = _rng.randn(4, 32).astype(np.float32)
VALUE_VAR = {"x": _rng.randn(4, 32).astype(np.float32),
             "y": _rng.randn(4, 32, 2).astype(np.float32)}
_rng = np.random.RandomState(5)
LW_SOFT = _rng.randn(8, 32).astype(np.float32)
VALUE_SOFT = {"x": _rng.randn(8, 32).astype(np.float32),
              "y": _rng.randn(8, 32, 2).astype(np.float32)}
LW_DEGENERATE = np.full((2, 64), -1e9, np.float32)
LW_DEGENERATE[:, 3] = 0.0
LATENT_DEGENERATE = np.random.RandomState(0).randn(2, 64).astype(np.float32)

CASES = {}
for _dp, _pp in MESHES:
    for _method in ("systematic", "stratified", "multinomial"):
        CASES[("indices", _dp, _pp, _method)] = ("indices", dict(
            dp=_dp, pp=_pp, lw=LW, method=_method,
            draws=_draws(_method, 8, 32)))
    for _exchange in ("allgather", "ring"):
        CASES[("ring", _dp, _pp, _exchange)] = ("fused", dict(
            dp=_dp, pp=_pp, lw=LW_RING, value=VALUE_RING,
            exchange=_exchange, method="systematic",
            draws=_draws("systematic", 8, 32)))
        CASES[("soft", _dp, _pp, _exchange)] = ("fused", dict(
            dp=_dp, pp=_pp, lw=LW_SOFT, value=VALUE_SOFT,
            exchange=_exchange, method="soft", soft_alpha=ALPHA,
            draws=_draws("multinomial", 8, 32),
            grad=(_dp, _pp) == (2, 4)))
    CASES[("logsumexp", _dp, _pp)] = ("logsumexp", dict(
        dp=_dp, pp=_pp, values=LW))
CASES["redistribute"] = ("redistribute", dict(
    dp=2, pp=4, lw=LW_SMALL, latent=LATENT,
    draws=_draws("systematic", 4, 16)))
CASES["degenerate"] = ("fused", dict(
    dp=1, pp=8, lw=LW_DEGENERATE, value=LATENT_DEGENERATE, exchange="ring",
    method="systematic", draws=_draws("systematic", 2, 64)))
for _exchange in ("allgather", "ring"):
    CASES[("spy", _exchange)] = ("fused", dict(
        dp=1, pp=8, lw=np.zeros((2, 8 * 64), np.float32),
        value=np.zeros((2, 8 * 64), np.float32), exchange=_exchange,
        method="systematic", draws=_draws("systematic", 2, 8 * 64),
        spy=True))
    for _method in ("stratified", "multinomial"):
        CASES[("variant", _method, _exchange)] = ("fused", dict(
            dp=2, pp=4, lw=LW_VAR, value=VALUE_VAR, exchange=_exchange,
            method=_method, draws=_draws(_method, 4, 32)))


@pytest.fixture(scope="module")
def world():
    """Every case of the file on one 8-rank world: name -> rank results."""
    names = list(CASES)
    results = torch_dist.run_world(8, [CASES[n] for n in names])
    return dict(zip(names, results))


def _blocks(results, key, dp, pp):
    return torch_dist.assemble([r[key] for r in results], dp, pp)


def _jax_mesh(dp, pp):
    return jax_parallel.make_mesh(data=dp, particle=pp)


class TestIndices:
    @pytest.mark.parametrize("dp,pp", MESHES)
    def test_systematic_exact_vs_jax_and_single_device(self, world, dp, pp):
        got = torch_dist.assemble(world[("indices", dp, pp, "systematic")],
                                  dp, pp)
        np.testing.assert_array_equal(
            got, np.asarray(jax_resampling.systematic_indices(LW, KEY)))
        if (dp, pp) == (2, 4):
            dist = jax_parallel.make_distributed_systematic_resampler(
                _jax_mesh(dp, pp))
            np.testing.assert_array_equal(got, np.asarray(dist(LW, KEY)))
        single = resampling.systematic_indices(
            torch.tensor(LW),
            torch_dist.ListNoise(**_draws("systematic", 8, 32)))
        np.testing.assert_array_equal(got, single.numpy())

    @pytest.mark.parametrize("dp,pp", MESHES)
    @pytest.mark.parametrize("method", ["stratified", "multinomial"])
    def test_variants_exact_vs_jax(self, world, method, dp, pp):
        got = torch_dist.assemble(world[("indices", dp, pp, method)], dp, pp)
        if (dp, pp) == (2, 4):
            dist = jax_parallel.make_distributed_resampler(
                _jax_mesh(dp, pp), method=method)
            np.testing.assert_array_equal(got, np.asarray(dist(LW, KEY)))
        want = jax_resampling._VARIANTS[method](LW, KEY)
        np.testing.assert_array_equal(got, np.asarray(want))

    def test_redistribution_exact(self, world):
        got = torch_dist.assemble(world["redistribute"], 2, 4)
        idx = jax_resampling.systematic_indices(LW_SMALL, KEY)
        np.testing.assert_array_equal(
            got, np.asarray(jax_state.resample(LATENT, idx)))

    @pytest.mark.parametrize("dp,pp", MESHES)
    def test_distributed_logsumexp(self, world, dp, pp):
        got = np.concatenate([world[("logsumexp", dp, pp)][d * pp]
                              for d in range(dp)])
        np.testing.assert_allclose(
            got, np.asarray(jax.nn.logsumexp(LW, axis=1)), rtol=1e-6)


class TestFusedExchange:
    def test_allgather_matches_jax_fused(self, world):
        results = world[("ring", 2, 4, "allgather")]
        fused = jax_parallel.make_distributed_fused_resampler(
            _jax_mesh(2, 4))
        want_idx, want_val = fused(LW_RING, KEY, VALUE_RING)
        np.testing.assert_array_equal(_blocks(results, "idx", 2, 4),
                                      np.asarray(want_idx))
        got = torch_dist.assemble([r["value"] for r in results], 2, 4)
        for k in VALUE_RING:
            np.testing.assert_array_equal(got[k], np.asarray(want_val[k]))

    @pytest.mark.parametrize("dp,pp", MESHES)
    def test_ring_equals_allgather_and_single_device(self, world, dp, pp):
        ring = world[("ring", dp, pp, "ring")]
        ag = world[("ring", dp, pp, "allgather")]
        np.testing.assert_array_equal(_blocks(ring, "idx", dp, pp),
                                      _blocks(ag, "idx", dp, pp))
        ring_val = torch_dist.assemble([r["value"] for r in ring], dp, pp)
        ag_val = torch_dist.assemble([r["value"] for r in ag], dp, pp)
        for k in VALUE_RING:
            np.testing.assert_array_equal(ring_val[k], ag_val[k])
        want_idx = np.asarray(jax_resampling.systematic_indices(LW_RING,
                                                                KEY))
        np.testing.assert_array_equal(_blocks(ring, "idx", dp, pp), want_idx)
        np.testing.assert_array_equal(
            ring_val["y"], np.asarray(jax_state.resample(
                VALUE_RING["y"], jnp.asarray(want_idx))))

    def test_degenerate_weights_cross_shard(self, world):
        results = world["degenerate"]
        np.testing.assert_array_equal(_blocks(results, "idx", 1, 8),
                                      np.full((2, 64), 3))
        np.testing.assert_array_equal(
            _blocks(results, "value", 1, 8),
            np.broadcast_to(LATENT_DEGENERATE[:, 3:4], (2, 64)))

    def test_ring_gathers_no_cloud_sized_tensor(self, world):
        k = 8 * 64

        def big(results):
            return [s for s in results[0]["gathers"] if k in s]

        assert big(world[("spy", "ring")]) == []
        assert big(world[("spy", "allgather")])
        # The ring's only gathers are the n = 8 shard sums of each row.
        assert all(s[0] == 8 for s in world[("spy", "ring")][0]["gathers"])

    @pytest.mark.parametrize("exchange", ["allgather", "ring"])
    @pytest.mark.parametrize("method", ["stratified", "multinomial"])
    def test_methods_x_exchanges_exact(self, world, method, exchange):
        results = world[("variant", method, exchange)]
        want_idx = np.asarray(jax_resampling._VARIANTS[method](LW_VAR, KEY))
        np.testing.assert_array_equal(_blocks(results, "idx", 2, 4),
                                      want_idx)
        got = torch_dist.assemble([r["value"] for r in results], 2, 4)
        want = jax_state.resample(VALUE_VAR, jnp.asarray(want_idx))
        for k in VALUE_VAR:
            np.testing.assert_array_equal(got[k], np.asarray(want[k]))


class TestSoft:
    def _single_device(self, lw):
        return jax_resampling.soft_resample_and_gather(
            lw, KEY, VALUE_SOFT, alpha=ALPHA, implementation="xla")

    @pytest.mark.parametrize("dp,pp", MESHES)
    def test_matches_jax_single_device(self, world, dp, pp):
        results = world[("soft", dp, pp, "allgather")]
        want_idx, want_corr, want_val = self._single_device(LW_SOFT)
        np.testing.assert_array_equal(_blocks(results, "idx", dp, pp),
                                      np.asarray(want_idx))
        np.testing.assert_allclose(_blocks(results, "corrected", dp, pp),
                                   np.asarray(want_corr), atol=1e-6)
        got = torch_dist.assemble([r["value"] for r in results], dp, pp)
        for k in VALUE_SOFT:
            np.testing.assert_allclose(got[k], np.asarray(want_val[k]),
                                       atol=1e-6)

    @pytest.mark.parametrize("dp,pp", MESHES)
    def test_ring_matches_allgather(self, world, dp, pp):
        ring = world[("soft", dp, pp, "ring")]
        ag = world[("soft", dp, pp, "allgather")]
        for key in ("idx", "corrected"):
            np.testing.assert_array_equal(_blocks(ring, key, dp, pp),
                                          _blocks(ag, key, dp, pp))
        ring_val = torch_dist.assemble([r["value"] for r in ring], dp, pp)
        ag_val = torch_dist.assemble([r["value"] for r in ag], dp, pp)
        for k in VALUE_SOFT:
            np.testing.assert_array_equal(ring_val[k], ag_val[k])

    @pytest.mark.parametrize("exchange", ["allgather", "ring"])
    def test_gradient_matches_jax_single_device(self, world, exchange):
        def single(lw_):
            _, corr, val = self._single_device(lw_)
            return jnp.sum(corr) + jnp.sum(val["x"])

        g_want = np.asarray(jax.grad(single)(jnp.asarray(LW_SOFT)))
        got = _blocks(world[("soft", 2, 4, exchange)], "grad", 2, 4)
        np.testing.assert_allclose(got, g_want, atol=1e-5)


class _StubMesh:
    """Enough of a `DeviceMesh` for the factories' checks."""

    mesh_dim_names = ("data", "particle")

    def get_group(self, name):
        return None


class TestErrors:
    def test_bad_exchange_raises(self):
        with pytest.raises(ValueError, match="exchange"):
            parallel.make_distributed_fused_resampler(_StubMesh(),
                                                      exchange="bogus")

    def test_bad_method_raises(self):
        with pytest.raises(ValueError, match="method"):
            parallel.make_distributed_resampler(_StubMesh(), method="bogus")
        with pytest.raises(ValueError, match="method"):
            parallel.make_distributed_fused_resampler(_StubMesh(),
                                                      method="bogus")

    def test_alpha_mismatch_raises(self):
        soft = parallel.make_distributed_fused_resampler(
            _StubMesh(), method="soft", soft_alpha=0.3)
        with pytest.raises(ValueError, match="soft_alpha"):
            resampling.soft_resample_and_gather(
                torch.tensor(LW_SOFT), None, None, alpha=0.5,
                implementation=soft)

    def test_soft_callable_in_plain_path_raises(self):
        soft = parallel.make_distributed_fused_resampler(_StubMesh(),
                                                         method="soft")
        with pytest.raises(ValueError, match="soft"):
            resampling.sample_ancestral_index_and_resample(
                torch.tensor(LW_SOFT), None, None, implementation=soft)

    def test_non_soft_callable_in_soft_path_raises(self):
        plain = parallel.make_distributed_fused_resampler(_StubMesh())
        with pytest.raises(ValueError, match="soft"):
            resampling.soft_resample_and_gather(
                torch.tensor(LW_SOFT), None, None, implementation=plain)

    def test_distributed_ot_resampler_names_e2(self):
        # Ported now (the name is the earlier slice's): the factory tags
        # its callable for the engine; a mesh without the axis raises.
        ot = parallel.make_distributed_ot_resampler(_StubMesh())
        assert ot.ot and ot.mesh is not None
        assert (ot.data_axis, ot.particle_axis) == ("data", "particle")
        with pytest.raises(ValueError, match="particle_axis"):
            parallel.make_distributed_ot_resampler(_StubMesh(),
                                                   particle_axis="island")
