"""The port's streaming filter (`aesmc_tpu_torch.online`) against the port's
own `infer` and against the JAX package's `make_online_filter`.

From one `NoiseSource`, `init_fn` and T - 1 `step_fn` calls draw what one
`infer('smc', ...)` call draws, in the same order, so they must give the
same bits: ancestors, particles, weights and log-Z, for every discrete
method, ESS-adaptive, the APF, soft and OT. Against the JAX package
(`tests/test_online.py:49-140`) the JAX draws are replayed: the
resampling noise from `split(key, (T, 2))[t, 0]` (the rows the JAX filter
takes from `split_step_keys`), the proposal's normals from `[t, 1]`
(`[K, B]` at t = 0, swapped), with the JAX CDF patched in so that the
ancestors compare exactly. The LGSSM of `tests/test_online.py`, T = 8,
B = 3, K = 64.

Tolerances: against the port's `infer`, `batched_steps` and the exported
step, none (bit for bit); against the JAX package, ancestors exact and
log-Z within 1e-4 (float32 in another order over the steps); the running
genealogy variance within 1e-4 of `variance.log_z_variance` (scatter-add
sums in another order); a time-reading emission within 1e-5 of `infer`'s
(the time is a float32 product of an int32 tensor there, of a Python int
here).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from aesmc_tpu import online as jax_online
from aesmc_tpu import resampling as jax_resampling
from aesmc_tpu.models import lgssm as jax_lgssm
from aesmc_tpu_torch import (distributions, inference, online, resampling,
                             smoothing, variance)
from aesmc_tpu_torch.models import lgssm
from aesmc_tpu_torch.noise import NoiseSource
from aesmc_tpu_torch.state import BatchShapeMode
from torch_replay import (IslandOnlyMesh, ReplayNoise, lgssm_params, normal_draw,
                          resampling_draws, tensor)

T, B, K = 8, 3, 64
KEY = jax.random.PRNGKey(7)


def _jax_components():
    return (jax_lgssm.Initial(0.0, 1.0),
            jax_lgssm.Transition.create(0.9, 1.0),
            jax_lgssm.Emission.create(1.0, 0.3),
            jax_lgssm.Proposal.create(1.0, 1.0, key=jax.random.PRNGKey(3)))


def _components():
    return lgssm.from_numpy(lgssm_params(_jax_components()), device="cpu")


def _observations():
    return np.asarray(jax.random.normal(jax.random.PRNGKey(11), (T, B)))


def _noise(seed=1):
    return NoiseSource.seeded(seed, "cpu")


def _stream(comps, obs, noise, **kwargs):
    init_fn, step_fn = online.make_online_filter(*comps, K, **kwargs)
    fs = init_fn(obs[0], noise)
    infos = []
    for t in range(1, len(obs)):
        fs, info = step_fn(fs, obs[t], noise)
        infos.append(info)
    return fs, infos


def _leaves_equal(a, b):
    la, lb = pytree.tree_leaves(a), pytree.tree_leaves(b)
    return len(la) == len(lb) and all(
        (x is None and y is None) or torch.equal(x, y) for x, y in zip(la, lb))


CASES = [("systematic", "always"), ("stratified", "always"),
         ("multinomial", "always"), ("residual", "always"),
         ("systematic", 0.2), ("multinomial", 0.2), ("soft", "always")]


@pytest.mark.parametrize("method,criterion", CASES)
def test_stream_equals_infer_bit_for_bit(method, criterion):
    comps, obs = _components(), torch.tensor(_observations())
    with torch.no_grad():
        ref = inference.infer(
            "smc", obs, *comps, K, noise=_noise(), resampling_method=method,
            resampling_criterion=criterion, soft_resampling_alpha=0.6,
            return_log_marginal_likelihood=True, return_latents=False,
            return_ancestral_indices=True)
        fs, infos = _stream(comps, obs, _noise(), resampling_method=method,
                            resampling_criterion=criterion,
                            soft_resampling_alpha=0.6, return_ancestors=True)
    assert torch.equal(online.log_marginal_likelihood(fs),
                       ref["log_marginal_likelihood"])
    assert torch.equal(fs.log_weight, ref["log_weight"])
    assert torch.equal(fs.latent, ref["last_latent"])
    assert torch.equal(torch.stack([i["ancestral_index"] for i in infos]),
                       ref["ancestral_indices"])
    assert int(fs.t) == T
    if criterion != "always":
        resampled = torch.stack([i["resampled"] for i in infos])
        assert bool(resampled.any()) and not bool(resampled.all())


@pytest.mark.parametrize("kwargs", [
    dict(lookahead=lgssm.Lookahead(0.9, 1.0, 1.0, 0.3)),
    dict(resampling_method="ot", ot_num_iterations=10),
    dict(resampling_method="ot", ot_num_iterations=10, ot_rank=8)])
def test_apf_and_ot_streams_equal_infer(kwargs):
    comps, obs = _components(), torch.tensor(_observations())
    with torch.no_grad():
        ref = inference.infer("smc", obs, *comps, K, noise=_noise(),
                              return_log_marginal_likelihood=True,
                              return_latents=False, **kwargs)
        fs, _ = _stream(comps, obs, _noise(), **kwargs)
    assert torch.equal(online.log_marginal_likelihood(fs),
                       ref["log_marginal_likelihood"])
    assert torch.equal(fs.latent, ref["last_latent"])


@pytest.fixture
def jax_cdf(monkeypatch):
    monkeypatch.setattr(resampling, "_normalized_cumsum", lambda lw: tensor(
        jax_resampling._normalized_cumsum(jnp.asarray(lw.detach().numpy()))))


@pytest.mark.parametrize("method,criterion", [
    ("systematic", "always"), ("stratified", "always"),
    ("multinomial", "always"), ("systematic", 0.2)])
def test_stream_replays_jax(method, criterion, jax_cdf):
    obs = _observations()
    init_fn, step_fn = jax_online.make_online_filter(
        *_jax_components(), K, resampling_method=method,
        resampling_criterion=criterion, return_ancestors=True)
    keys = jax_online.split_step_keys(KEY, T)
    fs = init_fn(jnp.asarray(obs[0]), keys[0])
    want_anc = []
    for t in range(1, T):
        fs, info = step_fn(fs, jnp.asarray(obs[t]), keys[t])
        want_anc.append(np.asarray(info["ancestral_index"]))
    step_keys = jax.random.split(KEY, (T, 2))
    noise = ReplayNoise(
        normals=[normal_draw(step_keys[0, 1], (K,), (B,),
                             batch_expanded=True)] +
        [normal_draw(step_keys[t, 1], (), (B, K)) for t in range(1, T)],
        **resampling_draws(KEY, T, B, K, method))
    with torch.no_grad():
        got, infos = _stream(_components(), torch.tensor(obs), noise,
                             resampling_method=method,
                             resampling_criterion=criterion,
                             return_ancestors=True)
    assert noise.exhausted()
    np.testing.assert_array_equal(
        torch.stack([i["ancestral_index"] for i in infos]).numpy(),
        np.stack(want_anc))
    np.testing.assert_allclose(
        online.log_marginal_likelihood(got).numpy(),
        np.asarray(jax_online.log_marginal_likelihood(fs)), atol=1e-4)
    assert int(got.t) == int(fs.t)


def test_genealogy_matches_batch_estimator():
    comps, obs = _components(), torch.tensor(_observations())
    with torch.no_grad():
        ref = inference.infer("smc", obs, *comps, K, noise=_noise(),
                              return_ancestral_indices=True,
                              return_latents=False)
        fs, infos = _stream(comps, obs, _noise(), track_genealogy=True)
    want = variance.log_z_variance(ref["log_weight"],
                                   ref["ancestral_indices"])
    np.testing.assert_allclose(infos[-1]["log_z_rel_var"].numpy(),
                               want.numpy(), atol=1e-4)
    assert torch.equal(fs.eve, variance.eve_indices(
        ref["ancestral_indices"]))
    assert torch.equal(fs.num_events, torch.full((B,), T - 1,
                                                 dtype=torch.int32))


def test_fixed_lag_is_the_traced_lineage():
    lag = 3
    comps, obs = _components(), torch.tensor(_observations())
    with torch.no_grad():
        ref = inference.infer("smc", obs, *comps, K, noise=_noise(),
                              return_ancestral_indices=True,
                              return_original_latents=True,
                              return_latents=False)
        _, infos = _stream(comps, obs, _noise(), fixed_lag=lag)
    original, anc = ref["original_latents"], ref["ancestral_indices"]
    for t in range(1, T):
        traced = inference.get_resampled_latents(original[:t + 1],
                                                 anc[:t])
        assert int(infos[t - 1]["lag_time"]) == t - lag
        assert torch.equal(infos[t - 1]["lagged_latent"],
                           traced[max(t - lag, 0)])


@pytest.mark.parametrize("backward", ["pairwise", "rejection"])
def test_streaming_paris_equals_offline(backward):
    comps, obs = _components(), torch.tensor(_observations())

    def h(xp, xc, time):
        return xp * xc

    with torch.no_grad():
        ref = smoothing.paris(obs, *comps, K, h, noise=_noise(),
                              h0=lambda x0: x0 * x0, backward=backward)
        fs, infos = _stream(comps, obs, _noise(), paris_h=h,
                            paris_h0=lambda x0: x0 * x0,
                            paris_backward=backward)
    assert torch.equal(infos[-1]["paris_smoothed"], ref["smoothed"])
    assert torch.equal(fs.tau, ref["tau"])
    assert torch.equal(online.log_marginal_likelihood(fs),
                       ref["log_marginal_likelihood"])
    if backward == "rejection":
        assert infos[-1]["paris_unconverged"].shape == (B,)


def test_batched_steps_equal_sequential_steps():
    comps, obs = _components(), torch.tensor(_observations())
    init_fn, step_fn = online.make_online_filter(*comps, K,
                                                 return_ancestors=True)
    with torch.no_grad():
        want, want_infos = _stream(comps, obs, _noise(),
                                   return_ancestors=True)
        noise = _noise()
        fs = init_fn(obs[0], noise)
        got, infos = online.batched_steps(step_fn)(fs, obs[1:], noise)
    assert _leaves_equal(tuple(got), tuple(want))
    for key in ("log_pred", "ess", "resampled", "ancestral_index"):
        assert infos[key].shape[0] == T - 1
        assert torch.equal(infos[key],
                           torch.stack([i[key] for i in want_infos]))


def test_export_load_round_trip_equals_live_step():
    comps, obs = _components(), torch.tensor(_observations())
    for kwargs in (dict(), dict(resampling_method="stratified",
                                track_genealogy=True, fixed_lag=2)):
        init_fn, step_fn = online.make_online_filter(*comps, K, **kwargs)
        with torch.no_grad():
            fs = init_fn(obs[0], _noise())
            fs, _ = step_fn(fs, obs[1], _noise(2))
            step = online.load_step(online.export_step(step_fn, fs, obs[2]))
            for t in (2, 3):
                want = step_fn(fs, obs[t], _noise(t))
                got = step(fs, obs[t], _noise(t))
                assert _leaves_equal(tuple(got[0]), tuple(want[0]))
                assert _leaves_equal(got[1], want[1])
                fs = got[0]


def test_time_reading_component_sees_every_step():
    """Components see a `DeviceTimeIndex`: `== 0` is False without a read,
    and its tensor holds t at every step; a time-dependent emission gives
    `infer`'s weights."""
    comps = list(_components())
    seen = []

    class TimedEmission(torch.nn.Module):
        def forward(self, latents=None, time=None,
                    previous_observations=None):
            seen.append(time)
            return distributions.Normal(
                latents[-1] + 0.05 * time, 0.3,
                batch_shape_mode=BatchShapeMode.FULLY_EXPANDED)

    comps[2] = TimedEmission()
    obs = torch.tensor(_observations())
    with torch.no_grad():
        ref = inference.infer("smc", obs, *comps, K, noise=_noise(),
                              return_log_marginal_likelihood=True,
                              return_latents=False)
        seen.clear()
        fs, _ = _stream(comps, obs, _noise())
    assert seen[0] == 0 and isinstance(seen[0], int)
    for t, time in enumerate(seen[1:], start=1):
        assert isinstance(time, inference.DeviceTimeIndex)
        assert not (time == 0) and time != 0
        assert int(time) == t and bool(time == t)
    np.testing.assert_allclose(fs.log_weight.numpy(),
                               ref["log_weight"].numpy(), atol=1e-5)


@pytest.mark.parametrize("kwargs,error,match", [
    (dict(resampling_method="soft", resampling_criterion=0.5), ValueError,
     "soft resampling"),
    (dict(resampling_method="ot", return_ancestors=True), ValueError,
     "ancestor indices"),
    (dict(resampling_method="ot", track_genealogy=True), ValueError,
     "genealogy"),
    (dict(resampling_method="ot", fixed_lag=2), ValueError, "fixed-lag"),
    (dict(resampling_method="ot", resampling_criterion=0.5), ValueError,
     "ESS-adaptive"),
    (dict(resampling_method="soft", lookahead=lambda **kw: 0.0), ValueError,
     "lookahead"),
    (dict(fixed_lag=-1), ValueError, "fixed_lag"),
    (dict(paris_h0=lambda x: x), ValueError, "paris_h0 requires"),
    (dict(paris_h=lambda a, b, t: b, paris_num_draws=0), ValueError,
     "paris_num_draws"),
    (dict(paris_h=lambda a, b, t: b, paris_backward="bogus"), ValueError,
     "paris_backward"),
    (dict(paris_h=lambda a, b, t: b, paris_pairwise="bogus"), ValueError,
     "paris_pairwise"),
    # On a mesh: a mesh without the particle axis, which the JAX
    # package's sharding constraints refuse too, whatever the method (on
    # a mesh with one, every method runs:
    # tests/test_torch_mesh_algorithms.py).
    (dict(mesh=IslandOnlyMesh(), paris_h=lambda a, b, t: b), ValueError,
     "particle_axis"),
    (dict(mesh=IslandOnlyMesh(), track_genealogy=True), ValueError,
     "particle_axis"),
    (dict(mesh=IslandOnlyMesh(), resampling_method="ot", ot_rank=4),
     ValueError, "particle_axis"),
    (dict(mesh=IslandOnlyMesh(), resampling_method="residual"), ValueError,
     "particle_axis"),
])
def test_validation(kwargs, error, match):
    with pytest.raises(error, match=match):
        online.make_online_filter(*_components(), K, **kwargs)


def test_len_raises_and_rejection_is_not_exported():
    comps, obs = _components(), torch.tensor(_observations())
    current = obs[0]
    view = online._CausalObservations(current)
    assert view[5] is current
    with pytest.raises(TypeError, match="len"):
        len(view)
    init_fn, step_fn = online.make_online_filter(
        *comps, K, paris_h=lambda a, b, t: b, paris_backward="rejection")
    with torch.no_grad():
        fs = init_fn(obs[0], _noise())
    with pytest.raises(ValueError, match="rejection"):
        online.export_step(step_fn, fs, obs[1])
