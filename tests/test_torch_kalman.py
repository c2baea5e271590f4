"""The port's scalar Kalman EM, the LGSSM's exact posterior and its
training callback against the JAX package's.

`kalman.kalman_em` and `lgssm.lgssm_true_posterior` are numpy float64 in
both packages: equal within 1e-12 relative. `lgssm.TrainingStats` takes
its held-out data from a `torch.Generator` (the JAX one from a key), so it
is held to the JAX package's `lgssm_true_posterior` on its own data
(1e-12) and to its parameter distance formula (exact), and a short
`train.train` run must record finite histories at the saving interval.
"""

import dataclasses

import numpy as np
import pytest
import torch

from aesmc_tpu.models import kalman as jax_kalman
from aesmc_tpu.models import lgssm as jax_lgssm
from aesmc_tpu_torch import train
from aesmc_tpu_torch.models import kalman, lgssm
from aesmc_tpu_torch.noise import NoiseSource
from torch_replay import simulate

PARAMS = dict(initial_mean=0.3, initial_variance=2.0, transition_mult=0.9,
              transition_offset=0.1, transition_variance=0.7,
              emission_mult=1.2, emission_offset=-0.2,
              emission_variance=0.4)


@pytest.mark.parametrize("em_vars", [
    None, ("transition_variance",), ("emission_variance", "initial_mean")])
def test_kalman_em_matches_jax(em_vars):
    y = simulate(3, 40, 1)[:, 0]
    kwargs = {} if em_vars is None else {"em_vars": em_vars}
    got = kalman.kalman_em(y, kalman.KalmanParams(**PARAMS),
                           num_iterations=6, **kwargs)
    want = jax_kalman.kalman_em(y, jax_kalman.KalmanParams(**PARAMS),
                                num_iterations=6, **kwargs)
    for name, value in dataclasses.asdict(want).items():
        np.testing.assert_allclose(getattr(got, name), value, rtol=1e-12)
    # The input parameters are left as they were.
    assert dataclasses.asdict(kalman.KalmanParams(**PARAMS)) == PARAMS


def test_lgssm_true_posterior_matches_jax():
    y = simulate(5, 25, 1)[:, 0]
    args = (0.1, 1.5, 0.8, 0.05, 0.9, 1.1, -0.1, 0.6)
    means, variances = lgssm.lgssm_true_posterior(y, *args)
    jax_means, jax_variances = jax_lgssm.lgssm_true_posterior(y, *args)
    assert means.shape == (25, 1) and variances.shape == (25, 1, 1)
    np.testing.assert_allclose(means, jax_means, rtol=1e-12)
    np.testing.assert_allclose(variances, jax_variances, rtol=1e-12)


def test_training_stats_records_during_train():
    stats = lgssm.TrainingStats(
        0.0, 1.0, 0.9, 1.0, 1.0, 0.2, num_timesteps=6, num_test_obs=3,
        test_inference_num_particles=16, saving_interval=2,
        logging_interval=100, verbose=False,
        generator=torch.Generator().manual_seed(42))
    obs = stats.test_obs.numpy()
    assert obs.shape == (6, 3)
    want = np.stack([jax_lgssm.lgssm_true_posterior(
        obs[:, i], 0.0, 1.0, 0.9, 0.0, 1.0, 1.0, 0.0, 0.2)[0].reshape(-1)
        for i in range(3)])
    np.testing.assert_allclose(stats.true_posterior_means, want, rtol=1e-12)
    learner = (lgssm.Initial(0.0, 1.0), lgssm.Transition(0.5, 1.0),
               lgssm.Emission(0.7, 0.2),
               lgssm.Proposal.create(1.0, 1.0,
                                     torch.Generator().manual_seed(0)))
    loader = train.get_synthetic_dataloader(
        lgssm.Initial(0.0, 1.0), lgssm.Transition(0.9, 1.0),
        lgssm.Emission(1.0, 0.2), 6, 4, NoiseSource.seeded(0, "cpu"))
    train.train(loader, 8, "aesmc", *learner, num_epochs=1,
                num_iterations_per_epoch=5, callback=stats,
                noise=NoiseSource.seeded(1, "cpu"))
    assert stats.iteration_idx_history == [0, 2, 4]
    assert len(stats.p_l2_history) == len(stats.q_l2_history) == 3
    assert np.isfinite(stats.q_l2_history).all()
    # The last record is the distance of the trained multipliers.
    np.testing.assert_array_equal(stats.p_l2_history[-1], np.linalg.norm(
        np.array([learner[1].mult.item(), learner[2].mult.item()]) -
        np.array([0.9, 1.0])))
