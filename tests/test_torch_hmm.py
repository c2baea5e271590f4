"""The port's discrete-latent HMM path against the JAX package.

The same HMM goes through both packages (`hmm.from_numpy` builds the
port's modules from the JAX components' fields). A categorical proposal's
noise does not depend on the particles, so the JAX run's draws are redrawn
from its key schedule: the Gumbel noise of each step's categorical draw
from ``split(key, (T, 2))[t, 1]`` in the shape `jax.random.categorical`
draws it, and the resampling noise from ``[t, 0]``. The port's CDF is
replaced by the JAX package's where ancestors are compared exactly: torch
and XLA add the cumulative sum in different orders, and a position within
rounding of a bin edge would otherwise pick the neighbouring ancestor.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aesmc_tpu import distributions as jax_dists
from aesmc_tpu import inference as jax_inference
from aesmc_tpu import losses as jax_losses
from aesmc_tpu import math as jax_math
from aesmc_tpu import resampling as jax_resampling
from aesmc_tpu import statistics as jax_statistics
from aesmc_tpu.models import hmm as jax_hmm
from aesmc_tpu_torch import (distributions, inference, losses, resampling,
                             statistics)
from aesmc_tpu_torch import math as amath
from aesmc_tpu_torch.models import hmm
from torch_replay import (ReplayNoise, categorical_gumbels, fields,
                          resampling_draws, tensor as _t)

D, T, B = 3, 25, 2


@functools.lru_cache(maxsize=2)
def _jax_setup(proposal="optimal"):
    """The JAX test's model and observations (tests/test_hmm.py:21-28)."""
    comps = jax_hmm.make_model(num_states=D, emission_scale=0.6,
                               stay_prob=0.85, proposal=proposal)
    _, obs = jax_statistics.sample_from_prior(
        *comps[:3], T, B, key=jax.random.PRNGKey(7))
    return comps, np.asarray(obs)


def _params(jax_comps):
    return dict(zip(("initial", "transition", "emission", "proposal"),
                    (fields(c) for c in jax_comps)))


def _oracle_args(jax_comps):
    initial, transition, emission, _ = jax_comps
    return (np.asarray(initial.logits), np.asarray(transition.logits),
            np.asarray(emission.locs), emission.scale)


def _jax_cdf(log_weight):
    return _t(jax_resampling._normalized_cumsum(
        jnp.asarray(log_weight.detach().numpy())))


# ---- math.table_lookup and distributions.Categorical.


@pytest.mark.parametrize("dtype", ["float32", "int32", "int8", "bool"])
def test_table_lookup_matches_jax(dtype):
    rng = np.random.default_rng(0)
    table = (rng.normal(size=(5, 2)) * 4).astype(dtype)
    idx = np.array([[0, 4, -1, -5], [-6, 5, 9, 2]], np.int32)
    for tab in (table, table[:, 0]):
        want = np.asarray(jax_math.table_lookup(jnp.asarray(tab),
                                                jnp.asarray(idx)))
        got = amath.table_lookup(_t(tab), _t(idx))
        assert got.dtype == _t(tab).dtype
        np.testing.assert_array_equal(got.numpy(), want)


def test_table_lookup_carries_a_gradient():
    table = torch.tensor([1.0, 2.0, 3.0], requires_grad=True)
    amath.table_lookup(table, torch.tensor([[0, 2, 2]])).sum().backward()
    assert torch.equal(table.grad, torch.tensor([1.0, 0.0, 2.0]))


def test_categorical_log_prob_matches_jax():
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(2, 3, 4)).astype(np.float32)
    value = np.array([[0, 3, -1], [-4, -5, 4]], np.int32)
    cases = [
        (logits, value),                        # same batch shape
        (logits[0, 0], value),                  # scalar-batch logits
        (logits, np.int32(2)),                  # scalar value
        (logits[:, :1], value),                 # [2, 1] against [2, 3]
        (logits, value.astype(np.float32)),     # float categories
    ]
    for lg, v in cases:
        want = np.asarray(jax_dists.Categorical(jnp.asarray(lg)).log_prob(
            jnp.asarray(v)))
        got = distributions.Categorical(_t(lg)).log_prob(_t(v)).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # An out-of-range category scores NaN, never a quiet 0.
    got = distributions.Categorical(_t(logits)).log_prob(_t(value)).numpy()
    assert np.isnan(got[1, 1]) and np.isnan(got[1, 2])
    assert np.isfinite(got[0]).all() and np.isfinite(got[1, 0])


def test_categorical_sample_is_gumbel_argmax():
    cat = distributions.Categorical.from_probs(torch.tensor([0.2, 0.5, 0.3]))
    assert cat.num_categories == 3 and cat.batch_shape == ()
    assert not cat.has_rsample
    gumbel = torch.zeros(2, 3)
    gumbel[0, 0] = 1.0
    got = cat.sample((2,), gumbel=gumbel)
    assert got.dtype == torch.int32 and got.tolist() == [0, 1]
    # A tie picks the first maximum, as jnp.argmax does.
    tie = distributions.Categorical(torch.zeros(3))
    assert tie.sample((), gumbel=torch.zeros(3)).item() == 0
    with pytest.raises(ValueError, match="gumbel has shape"):
        cat.sample((2,), gumbel=torch.zeros(3, 3))


# ---- models.hmm: oracles and components.


def test_log_softmax_matches_jax():
    comps, _ = _jax_setup()
    for logits in _oracle_args(comps)[:2]:
        want = np.asarray(jax.nn.log_softmax(jnp.asarray(logits), axis=-1))
        # JAX computes in float32; the port's copy in float64.
        np.testing.assert_allclose(hmm.log_softmax(logits), want, rtol=0,
                                   atol=1e-6)


def test_oracles_match_jax(monkeypatch):
    """The four recursions agree to 1e-10 given the same log-probabilities:
    JAX's oracles run their log_softmax in float32 (`jax.nn.log_softmax`),
    the port's in float64, so the JAX side gets the port's log_softmax
    here (the test above holds the two log_softmaxes together)."""
    comps, obs = _jax_setup()
    args = _oracle_args(comps)
    monkeypatch.setattr(jax.nn, "log_softmax",
                        lambda x, axis=-1: hmm.log_softmax(np.asarray(x),
                                                           axis))
    for b in range(B):
        y = obs[:, b]
        filt, ll = hmm.hmm_forward(y, *args)
        want_filt, want_ll = jax_hmm.hmm_forward(y, *args)
        np.testing.assert_allclose(filt, want_filt, rtol=0, atol=1e-10)
        assert abs(ll - want_ll) < 1e-10
        np.testing.assert_allclose(hmm.hmm_smoother(y, *args),
                                   jax_hmm.hmm_smoother(y, *args),
                                   rtol=0, atol=1e-10)
        path, logp = hmm.hmm_viterbi(y, *args)
        want_path, want_logp = jax_hmm.hmm_viterbi(y, *args)
        np.testing.assert_array_equal(path, want_path)
        assert abs(logp - want_logp) < 1e-10
        np.testing.assert_allclose(
            hmm.hmm_pairwise_marginals(y, *args),
            jax_hmm.hmm_pairwise_marginals(y, *args), rtol=0, atol=1e-10)


@pytest.mark.parametrize("proposal", ["optimal", "bootstrap"])
def test_from_numpy_and_make_model(proposal):
    comps, obs = _jax_setup(proposal)
    ported = hmm.from_numpy(_params(comps), device="cpu")
    made = hmm.make_model(num_states=D, emission_scale=0.6, stay_prob=0.85,
                          proposal=proposal, device="cpu")
    kind = hmm.Proposal if proposal == "optimal" else hmm.BootstrapProposal
    assert isinstance(ported[3], kind) and isinstance(made[3], kind)
    for a, b in zip(ported, made):
        for (name, x), (_, y) in zip(
                list(a.named_parameters()) + list(a.named_buffers()),
                list(b.named_parameters()) + list(b.named_buffers())):
            np.testing.assert_allclose(x.detach().numpy(),
                                       y.detach().numpy(), rtol=1e-6,
                                       err_msg=name)
    assert [n for n, _ in ported[2].named_parameters()] == ["locs"]
    prev = _t(np.array([[0, 2], [1, 1]], np.int32))
    lb = ported[1].log_bound(prev, 1, None)
    want = np.asarray(comps[1].log_bound(jnp.asarray(prev.numpy()), 1, None))
    np.testing.assert_allclose(lb.numpy(), want, rtol=1e-6)
    if proposal == "optimal":
        obs_seq = inference.ObservationSequence(_t(obs))
        jax_seq = jax_inference.ObservationSequence(jnp.asarray(obs))
        for time, prev_latents in ((0, None), (3, [prev])):
            got = ported[3](previous_latents=prev_latents, time=time,
                            observations=obs_seq).logits
            want = comps[3](previous_latents=None if prev_latents is None
                            else [jnp.asarray(prev.numpy())], time=time,
                            observations=jax_seq).logits
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="proposal"):
        hmm.make_model(proposal="bogus", device="cpu")


def test_sample_from_prior_matches_jax():
    """Categorical latents through `state.sample`, under JAX's replayed
    draws: identical int32 latents and observations."""
    comps, obs = _jax_setup()
    key = jax.random.PRNGKey(7)
    jax_latents, _ = jax_statistics.sample_from_prior(*comps[:3], T, B,
                                                      key=key)
    step_keys = jax.random.split(key, (T, 2))
    noise = ReplayNoise(
        gumbels=[jax.random.gumbel(step_keys[t, 0], (B, 1, D),
                                   dtype=jnp.float32) for t in range(T)],
        normals=[jax.random.normal(step_keys[t, 1], (B, 1),
                                   dtype=jnp.float32) for t in range(T)])
    ported = hmm.from_numpy(_params(comps), device="cpu")
    with torch.no_grad():
        latents, got_obs = statistics.sample_from_prior(*ported[:3], T, B,
                                                        noise)
    assert noise.exhausted()
    assert latents.dtype == torch.int32 and latents.shape == (T, B)
    np.testing.assert_array_equal(latents.numpy(), np.asarray(jax_latents))
    np.testing.assert_allclose(got_obs.numpy(), obs, rtol=0, atol=1e-5)


# ---- The filter.


def _replayed(key, k, method, first="batch_expanded"):
    return ReplayNoise(
        gumbels=categorical_gumbels(key, T, B, k, D, first),
        **resampling_draws(key, T, B, k, method))


@pytest.mark.parametrize("method", ["systematic", "stratified",
                                    "multinomial"])
@pytest.mark.parametrize("k", [64, 512])
def test_filter_matches_jax_exactly(k, method, monkeypatch):
    comps, obs = _jax_setup()
    key = jax.random.PRNGKey(11)
    want = jax_inference.infer(
        "smc", jnp.asarray(obs), *comps, k, key=key,
        resampling_method=method, return_log_marginal_likelihood=True,
        return_original_latents=True, return_ancestral_indices=True)
    monkeypatch.setattr(resampling, "_normalized_cumsum", _jax_cdf)
    noise = _replayed(key, k, method)
    with torch.no_grad():
        got = inference.infer(
            "smc", _t(obs), *hmm.from_numpy(_params(comps), device="cpu"),
            k, noise=noise, resampling_method=method,
            return_log_marginal_likelihood=True,
            return_original_latents=True, return_ancestral_indices=True)
    assert noise.exhausted()
    for name in ("original_latents", "ancestral_indices", "latents"):
        assert got[name].dtype == torch.int32, name
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]), name)
    np.testing.assert_allclose(got["log_marginal_likelihood"].numpy(),
                               np.asarray(want["log_marginal_likelihood"]),
                               rtol=0, atol=1e-4)


def test_bootstrap_filter_matches_jax(monkeypatch):
    """The bootstrap proposal's t = 0 prior is NOT_EXPANDED: its Gumbel
    noise is drawn `[B, K, D]`."""
    comps, obs = _jax_setup("bootstrap")
    key, k = jax.random.PRNGKey(12), 128
    want = jax_inference.infer(
        "smc", jnp.asarray(obs), *comps, k, key=key,
        return_log_marginal_likelihood=True, return_ancestral_indices=True)
    monkeypatch.setattr(resampling, "_normalized_cumsum", _jax_cdf)
    noise = _replayed(key, k, "systematic", first="not_expanded")
    with torch.no_grad():
        got = inference.infer(
            "smc", _t(obs), *hmm.from_numpy(_params(comps), device="cpu"),
            k, noise=noise, return_log_marginal_likelihood=True,
            return_ancestral_indices=True)
    assert noise.exhausted()
    np.testing.assert_array_equal(got["latents"].numpy(),
                                  np.asarray(want["latents"]))
    np.testing.assert_allclose(got["log_marginal_likelihood"].numpy(),
                               np.asarray(want["log_marginal_likelihood"]),
                               rtol=0, atol=1e-4)


def test_log_z_matches_exact_forward():
    """tests/test_hmm.py:45-57 on the port: multinomial resampling at
    K=2048 under that test's keys (observations PRNGKey(7), inference
    PRNGKey(2)), on the port's own CDF; log-Z within 0.05 of the forward
    recursion."""
    comps, obs = _jax_setup()
    k = 2048
    noise = _replayed(jax.random.PRNGKey(2), k, "multinomial")
    with torch.no_grad():
        out = inference.infer(
            "smc", _t(obs), *hmm.from_numpy(_params(comps), device="cpu"),
            k, noise=noise, resampling_method="multinomial",
            return_log_marginal_likelihood=True, return_latents=False)
    log_z = out["log_marginal_likelihood"].numpy()
    for b in range(B):
        _, exact = hmm.hmm_forward(obs[:, b], *_oracle_args(comps))
        assert abs(log_z[b] - exact) < 0.05, (b, log_z[b], exact)


def test_aesmc_loss_and_locs_gradient_match_jax(monkeypatch):
    """One AESMC loss and its gradient in the emission means: the latents
    are detached integers, and the gradient flows through the emission
    density into the log-weights."""
    comps, obs = _jax_setup()
    initial, transition, emission, proposal = comps
    emission = jax_hmm.Emission(
        locs=emission.locs + jnp.asarray([0.8, -0.6, 0.7]),
        scale=emission.scale)
    key, k = jax.random.PRNGKey(0), 256
    want_loss, want_grad = jax.value_and_grad(
        lambda em: jax_losses.get_loss(jnp.asarray(obs), k, "aesmc",
                                       initial, transition, em, proposal,
                                       key=key))(emission)
    monkeypatch.setattr(resampling, "_normalized_cumsum", _jax_cdf)
    ported = hmm.from_numpy(_params((initial, transition, emission,
                                     proposal)), device="cpu")
    noise = _replayed(key, k, "systematic")
    loss = losses.get_loss(_t(obs), k, "aesmc", *ported, noise=noise)
    loss.backward()
    assert noise.exhausted()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-4)
    np.testing.assert_allclose(ported[2].locs.grad.numpy(),
                               np.asarray(want_grad.locs), rtol=1e-4,
                               atol=1e-6)
