"""The port's Lorenz-96 model (`aesmc_tpu_torch.models.lorenz`) against the
JAX package's.

The drift and the RK4 step on the same inputs; the bootstrap filter and
the assimilation filters (the closed-form 'diagonal' proposal and the
generic 'extended' and 'unscented' ones through `proposals.ekf_proposal`)
against the JAX package's `infer` under replayed draws: the systematic
uniforms from `split(key, (T, 2))[t, 0]` and the proposals' standard
normals from `[t, 1]` (`[K, B, D]` at t = 0 for a BATCH_EXPANDED proposal,
swapped), with the JAX package's CDF patched in so that the ancestors
compare exactly. D = 8 with every other component observed, T = 6, B = 2,
K = 64.

Tolerances: drift and RK4 within 1e-6 absolute at |x| ~ 10 (float32, the
same arithmetic in another fusion); ancestors exactly equal; log-Z within
1e-4 (float32 sums over steps in another order); the three proposals'
loc and scale within 1e-5 of one another (the closed form against
batched Cholesky algebra).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aesmc_tpu import inference as jax_inference
from aesmc_tpu import resampling as jax_resampling
from aesmc_tpu import statistics as jax_statistics
from aesmc_tpu.models import lorenz as jax_lorenz
from aesmc_tpu_torch import inference, resampling
from aesmc_tpu_torch.models import lorenz
from torch_replay import ReplayNoise, fields, normal_draw, tensor

D, T, B, K = 8, 6, 2, 64
OBS = tuple(range(0, D, 2))
KEY = jax.random.PRNGKey(3)


def test_drift_and_rk4_match_jax():
    x = (np.random.RandomState(0).randn(5, D) * 3 + 8).astype(np.float32)
    np.testing.assert_allclose(
        lorenz.lorenz96_drift(torch.tensor(x)).numpy(),
        np.asarray(jax_lorenz.lorenz96_drift(jnp.asarray(x))), atol=1e-6)
    np.testing.assert_allclose(
        lorenz.rk4_step(torch.tensor(x), 0.05, 8.0).numpy(),
        np.asarray(jax_lorenz.rk4_step(jnp.asarray(x), 0.05, 8.0)),
        atol=1e-6)


def _jax_model(proposal, linearization):
    initial, transition, emission, prop = jax_lorenz.make_model(
        dim=D, emission_scale=0.7, obs_indices=OBS, proposal=proposal)
    if proposal == "assimilation" and linearization != "diagonal":
        prop = jax_lorenz.assimilation_proposal(
            initial, transition, emission, linearization=linearization)
    return initial, transition, emission, prop


def _port_model(jax_comps, proposal, linearization):
    params = {name: fields(c) for name, c in
              zip(("initial", "transition", "emission"), jax_comps[:3])}
    comps = lorenz.from_numpy(params, proposal=proposal, device="cpu")
    if proposal == "assimilation" and linearization != "diagonal":
        comps = comps[:3] + (lorenz.assimilation_proposal(
            *comps[:3], linearization=linearization),)
    return comps


@pytest.fixture
def jax_cdf(monkeypatch):
    monkeypatch.setattr(resampling, "_normalized_cumsum", lambda lw: tensor(
        jax_resampling._normalized_cumsum(jnp.asarray(lw.detach().numpy()))))


@pytest.mark.parametrize("proposal,linearization", [
    ("bootstrap", "diagonal"), ("assimilation", "diagonal"),
    ("assimilation", "extended"), ("assimilation", "unscented")])
def test_filter_replays_jax(proposal, linearization, jax_cdf):
    jax_comps = _jax_model(proposal, linearization)
    _, obs = jax_statistics.sample_from_prior(*jax_comps[:3], T, B,
                                              jax.random.PRNGKey(1))
    want = jax_inference.infer(
        "smc", obs, *jax_comps, K, key=KEY,
        return_log_marginal_likelihood=True, return_ancestral_indices=True,
        return_latents=False)
    keys = jax.random.split(KEY, (T, 2))
    # t = 0: the bootstrap proposal is the NOT_EXPANDED prior, drawn [B, K,
    # D]; the assimilation proposals are BATCH_EXPANDED, drawn [K, B, D].
    first = (normal_draw(keys[0, 1], (B, K), (D,)) if proposal == "bootstrap"
             else normal_draw(keys[0, 1], (K,), (B, D), batch_expanded=True))
    noise = ReplayNoise(
        uniforms=[np.asarray(jax.random.uniform(keys[t, 0], (B, 1)))
                  for t in range(1, T)],
        normals=[first] + [normal_draw(keys[t, 1], (), (B, K, D))
                           for t in range(1, T)])
    comps = _port_model(jax_comps, proposal, linearization)
    with torch.no_grad():
        got = inference.infer(
            "smc", tensor(obs), *comps, K, noise=noise,
            return_log_marginal_likelihood=True,
            return_ancestral_indices=True, return_latents=False)
    assert noise.exhausted()
    np.testing.assert_array_equal(got["ancestral_indices"].numpy(),
                                  np.asarray(want["ancestral_indices"]))
    np.testing.assert_allclose(got["log_marginal_likelihood"].numpy(),
                               np.asarray(want["log_marginal_likelihood"]),
                               atol=1e-4)


def test_linearizations_agree():
    model = lorenz.make_model(dim=D, obs_indices=OBS, device="cpu")[:3]
    comps = {lin: lorenz.assimilation_proposal(*model, linearization=lin)
             for lin in ("diagonal", "extended", "unscented")}
    rng = np.random.RandomState(2)
    x_prev = torch.tensor((rng.randn(B, K, D) * 2 + 8).astype(np.float32))
    obs = inference.ObservationSequence(torch.tensor(
        (rng.randn(3, B, len(OBS)) + 8).astype(np.float32)))

    def moments(prop, t):
        if t == 0:
            d = prop(time=0, observations=obs)
        else:
            d = prop(previous_latents=[x_prev], time=inference.TimeIndex(t),
                     observations=obs)
        scale = (d.scale_diag if hasattr(d, "scale_diag") else
                 torch.diagonal(d.scale_tril, dim1=-2, dim2=-1))
        return d.loc, scale.expand_as(d.loc)

    for t in (0, 1):
        loc, scale = moments(comps["diagonal"], t)
        for lin in ("extended", "unscented"):
            other_loc, other_scale = moments(comps[lin], t)
            np.testing.assert_allclose(other_loc.numpy(), loc.numpy(),
                                       atol=1e-5)
            np.testing.assert_allclose(other_scale.numpy(), scale.numpy(),
                                       atol=1e-5)


def test_proposals_follow_the_components_device():
    """`assimilation_proposal` builds its buffers where the components are
    (the meta device stands in for the card)."""
    model = lorenz.make_model(dim=D, obs_indices=OBS, device="meta")[:3]
    for lin in ("diagonal", "extended", "unscented"):
        prop = lorenz.assimilation_proposal(*model, linearization=lin)
        assert {b.device.type for b in prop.buffers()} == {"meta"}, lin


def test_validation():
    with pytest.raises(ValueError, match="proposal"):
        lorenz.make_model(proposal="bogus", device="cpu")
