"""The port's NaN guard against the JAX package's.

Ports the five cases of `tests/test_nan_check.py`: `checked_loss` on
clean and on NaN weights (the JAX package's verdict beside the port's),
the checked train step raising FloatingPointError and matching the
unchecked step on clean data, and `infer(nan_check=True)` raising. The
port's checked step also leaves the parameters and Adam's state
bit-identical when it raises.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aesmc_tpu import distributions as jax_dists
from aesmc_tpu import losses as jax_losses
from aesmc_tpu import statistics as jax_statistics
from aesmc_tpu.models import lgssm as jax_lgssm
from aesmc_tpu.state import BatchShapeMode as JaxMode
from aesmc_tpu_torch import distributions, inference, losses, train
from aesmc_tpu_torch.models import lgssm
from aesmc_tpu_torch.noise import NoiseSource
from aesmc_tpu_torch.state import BatchShapeMode
from torch_replay import lgssm_params, tensor

KEY = jax.random.PRNGKey(0)
CPU = "cpu"
T, B, K = 8, 3, 16


def _jax_components():
    return (jax_lgssm.Initial(0.0, 1.0),
            jax_lgssm.Transition.create(0.9, 1.0),
            jax_lgssm.Emission.create(1.0, 0.2),
            jax_lgssm.Proposal.create(1.0, 1.0, KEY))


def _setup():
    jax_comps = _jax_components()
    _, obs = jax_statistics.sample_from_prior(*jax_comps[:3], T, B, KEY)
    return jax_comps, obs, lgssm.from_numpy(lgssm_params(jax_comps),
                                            device=CPU)


class NanEmission:
    """NaN log-probabilities from time step 2 on."""

    def __call__(self, latents=None, time=None, previous_observations=None):
        scale = float("nan") if time >= 2 else 0.2
        return distributions.Normal(
            latents[-1], scale, batch_shape_mode=BatchShapeMode.FULLY_EXPANDED)


def _jax_nan_emission(latents=None, time=None, previous_observations=None):
    scale = jnp.where(jnp.asarray(time) >= 2, jnp.nan, 0.2)
    return jax_dists.Normal(latents[-1], scale,
                            batch_shape_mode=JaxMode.FULLY_EXPANDED)


def test_clean_run_no_error():
    jax_comps, obs, comps = _setup()
    jax_err, _ = jax_losses.checked_loss(obs, K, "aesmc", *jax_comps, key=KEY)
    err, loss = losses.checked_loss(tensor(obs), K, "aesmc", *comps,
                                    noise=NoiseSource.seeded(0, CPU))
    assert jax_err.get() is None and err.get() is None
    assert torch.isfinite(loss)
    err.throw()


def test_nan_weights_recorded():
    jax_comps, obs, comps = _setup()
    jax_err, _ = jax_losses.checked_loss(
        obs, K, "aesmc", jax_comps[0], jax_comps[1], _jax_nan_emission,
        jax_comps[3], key=KEY)
    err, _ = losses.checked_loss(tensor(obs), K, "aesmc", comps[0],
                                 comps[1], NanEmission(), comps[3],
                                 noise=NoiseSource.seeded(0, CPU))
    assert "nan" in jax_err.get() and "nan" in err.get()
    with pytest.raises(FloatingPointError, match="nan"):
        err.throw()


def test_step_raises_and_leaves_the_state():
    """After one clean step (so that Adam has state), a NaN step raises
    FloatingPointError; the parameters and Adam's state are bit-identical
    to what they were before it."""
    _, obs, comps = _setup()
    optimizer = torch.optim.Adam(train.get_chained_params(*comps), lr=1e-2)
    step = train.make_train_step(K, "aesmc", optimizer, nan_check=True)
    noise = NoiseSource.seeded(0, CPU)
    step(comps, tensor(obs), noise)
    params = [p.detach().clone() for p in train.get_chained_params(*comps)]
    adam = copy.deepcopy(optimizer.state_dict())
    nan_comps = (comps[0], comps[1], NanEmission(), comps[3])
    with pytest.raises(FloatingPointError, match="nan"):
        step(nan_comps, tensor(obs), noise)
    for before, p in zip(params, train.get_chained_params(*comps)):
        assert torch.equal(before, p.detach())
        assert p.grad is None
    after = optimizer.state_dict()
    assert after["param_groups"] == adam["param_groups"]
    for i, state in adam["state"].items():
        for name, value in state.items():
            assert torch.equal(value, after["state"][i][name]), name


def test_clean_step_passes_and_matches_unchecked():
    _, obs, _ = _setup()
    results = []
    for nan_check in (True, False):
        comps = lgssm.from_numpy(lgssm_params(_jax_components()),
                                 device=CPU)
        optimizer = torch.optim.Adam(train.get_chained_params(*comps),
                                     lr=1e-2)
        step = train.make_train_step(K, "aesmc", optimizer,
                                     nan_check=nan_check)
        loss = step(comps, tensor(obs), NoiseSource.seeded(0, CPU))
        results.append((loss, train.get_chained_params(*comps)))
    (loss1, params1), (loss2, params2) = results
    assert torch.equal(loss1, loss2)
    for a, b in zip(params1, params2):
        assert torch.equal(a, b)


def test_eager_infer_raises_immediately():
    _, obs, comps = _setup()
    with pytest.raises(FloatingPointError, match="nan"):
        inference.infer("smc", tensor(obs), comps[0], comps[1],
                        NanEmission(), comps[3], K,
                        noise=NoiseSource.seeded(0, CPU), nan_check=True,
                        return_log_marginal_likelihood=True)
    # 'is' never resamples: nothing to guard, as in the JAX package.
    out = inference.infer("is", tensor(obs), comps[0], comps[1],
                          NanEmission(), comps[3], K,
                          noise=NoiseSource.seeded(0, CPU), nan_check=True,
                          return_log_marginal_likelihood=True)
    assert np.isnan(out["log_marginal_likelihood"].detach().numpy()).all()
