"""`train.train_on_device` in the port.

Ports `tests/test_train.py::TestTrainOnDevice` (120 steps in blocks of
50 from the JAX test's initial proposal: the callback runs after steps
50, 100 and 120, the transition moves toward the truth and the loss
falls). The JAX package's `train_on_device` is replayed into the port's:
each step's prior draws (from its data key) and step draws (from its
step key) go to the port's noise source in the order the port's loop
draws them, and the losses, the callback's block means and the final
parameters agree. On the CPU the steps run eagerly: they equal a loop of
`make_train_step` steps on observations sampled from the same noise
source, bit for bit. An optimizer over parameters on the card built
without ``capturable=True`` raises. The CUDA-graph capture itself runs
only on the card (`tests/test_torch_graph.py`).
"""

import types

import jax
import numpy as np
import optax
import pytest
import torch

from aesmc_tpu import inference as jax_inference
from aesmc_tpu import statistics as jax_statistics
from aesmc_tpu import train as jax_train
from aesmc_tpu.models import lgssm as jax_lgssm
from aesmc_tpu_torch import statistics, train
from aesmc_tpu_torch.models import lgssm
from aesmc_tpu_torch.noise import NoiseSource
from torch_replay import (ReplayNoise, fields, lgssm_params,
                          replayed_noise)

CPU = "cpu"


def _learner():
    """The JAX test's learner: transition 0.0, emission 0.3, the proposal
    `Proposal.create(1.0, 1.0, PRNGKey(0))`."""
    proposal = fields(jax_lgssm.Proposal.create(1.0, 1.0,
                                                jax.random.PRNGKey(0)))
    return (lgssm.Initial(0.0, 1.0), lgssm.Transition(0.0, 1.0),
            lgssm.Emission(0.3, 0.1), lgssm.Proposal(**proposal))


def _generative():
    return (lgssm.Initial(0.0, 1.0), lgssm.Transition(0.9, 1.0),
            lgssm.Emission(1.0, 0.1))


# The generative model of the JAX test: (initial loc, scale), (transition
# mult, scale), (emission mult, scale).
GENERATIVE = ((0.0, 1.0), (0.9, 1.0), (1.0, 0.1))


def _jax_learner():
    return (jax_lgssm.Initial(0.0, 1.0),
            jax_lgssm.Transition.create(0.0, 1.0),
            jax_lgssm.Emission.create(0.3, 0.1),
            jax_lgssm.Proposal.create(1.0, 1.0, jax.random.PRNGKey(0)))


def _jax_generative():
    (loc, scale), (tr_mult, tr_scale), (em_mult, em_scale) = GENERATIVE
    return (jax_lgssm.Initial(loc, scale),
            jax_lgssm.Transition.create(tr_mult, tr_scale),
            jax_lgssm.Emission.create(em_mult, em_scale))


def _prior_normals(latents, observations):
    """The standard-normal draws, in the port's order (x_0, y_0, x_1, y_1,
    ...), each `[B, 1]`, with which the port's `sample_from_prior` of the
    generative model gives the JAX package's ``latents`` and
    ``observations`` `[T, B]`."""
    (loc, scale), (tr_mult, tr_scale), (em_mult, em_scale) = GENERATIVE
    x = np.asarray(latents, np.float64)
    y = np.asarray(observations, np.float64)
    draws = []
    for t in range(len(x)):
        prev = loc if t == 0 else tr_mult * x[t - 1]
        draws.append((x[t] - prev) / (scale if t == 0 else tr_scale))
        draws.append((y[t] - em_mult * x[t]) / em_scale)
    return [d[:, None].astype(np.float32) for d in draws]


def test_replays_jax_train_on_device():
    """4 steps in blocks of 2 of the JAX package's `train_on_device`
    against the port's, with the JAX run's draws replayed."""
    num_timesteps, batch, k, lr, num_steps, key = 6, 4, 16, 1e-2, 4, 5
    blocks, jax_blocks = [], []
    jax_out, jax_hist = jax_train.train_on_device(
        *_jax_learner(), num_particles=k, algorithm="aesmc",
        generative_components=_jax_generative(),
        num_timesteps=num_timesteps, batch_size=batch, num_steps=num_steps,
        optimizer=optax.adam(lr), key=jax.random.PRNGKey(key),
        steps_per_call=2, callback=lambda i, l, c: jax_blocks.append((i, l)))

    # The JAX loop's draws, step by step, at the parameters of each step:
    # key, k_data, k_step = split(key, 3); the observations are sampled
    # from k_data and the step draws from k_step.
    jax_comps, optimizer = _jax_learner(), optax.adam(lr)
    opt_state = optimizer.init(jax_comps)
    jax_step = jax_train.make_train_step(k, "aesmc", optimizer, jit=False)
    noise = ReplayNoise()
    key = jax.random.PRNGKey(key)
    for _ in range(num_steps):
        key, k_data, k_step = jax.random.split(key, 3)
        latents, obs = jax_statistics.sample_from_prior(
            *_jax_generative(), num_timesteps, batch, k_data)
        out = jax_inference.infer(
            "smc", obs, *jax_comps, k, key=k_step,
            return_original_latents=True, return_ancestral_indices=True)
        step_noise = replayed_noise(jax_comps[3], obs, k_step,
                                    out["original_latents"],
                                    out["ancestral_indices"])
        noise.normals += ReplayNoise(
            normals=_prior_normals(latents, obs)).normals
        noise.normals += step_noise.normals
        noise.uniforms += step_noise.uniforms
        jax_comps, opt_state, _ = jax_step(jax_comps, opt_state, obs,
                                           k_step)

    comps = lgssm.from_numpy(lgssm_params(_jax_learner()), device=CPU)
    out, hist = train.train_on_device(
        *comps, num_particles=k, algorithm="aesmc",
        generative_components=_generative(), num_timesteps=num_timesteps,
        batch_size=batch, num_steps=num_steps,
        optimizer=torch.optim.Adam(train.get_chained_params(*comps), lr=lr),
        noise=noise, steps_per_call=2,
        callback=lambda i, l, c: blocks.append((i, l)))
    assert noise.exhausted()
    np.testing.assert_allclose(hist.numpy(), np.asarray(jax_hist),
                               rtol=1e-5)
    assert [b[0] for b in blocks] == [b[0] for b in jax_blocks] == [2, 4]
    np.testing.assert_allclose([b[1] for b in blocks],
                               [b[1] for b in jax_blocks], rtol=1e-5)
    for got, want in zip(out, jax_out):
        for name, value in fields(want).items():
            np.testing.assert_allclose(
                torch.as_tensor(getattr(got, name)).detach().numpy(), value,
                rtol=1e-5,
                atol=1e-6, err_msg=f"{type(got).__name__}.{name}")


def test_fused_loop_learns():
    blocks = []
    comps = _learner()
    optimizer = torch.optim.Adam(train.get_chained_params(*comps), lr=5e-2)
    out, hist = train.train_on_device(
        *comps, num_particles=32, algorithm="aesmc",
        generative_components=_generative(), num_timesteps=10, batch_size=8,
        num_steps=120, optimizer=optimizer,
        noise=NoiseSource.seeded(0, CPU), steps_per_call=50,
        callback=lambda i, loss, c: blocks.append((i, loss, c)))
    assert out is not None and out[1] is comps[1]
    assert hist.shape == (120,) and not hist.requires_grad
    assert [b[0] for b in blocks] == [50, 100, 120]
    assert all(isinstance(b[1], float) and b[2] is out for b in blocks)
    np.testing.assert_allclose(blocks[-1][1], hist[100:].mean().item(),
                               rtol=1e-6)
    assert abs(comps[1].mult.item() - 0.9) < 0.45
    assert hist[-30:].mean() < hist[:30].mean()


def test_eager_run_equals_make_train_step_loop():
    """6 steps in blocks of 4 against 6 `make_train_step` steps, each on
    observations sampled from the same noise source just before it."""
    runs = []
    for fused in (True, False):
        comps = _learner()
        optimizer = torch.optim.Adam(train.get_chained_params(*comps),
                                     lr=1e-2)
        noise = NoiseSource.seeded(3, CPU)
        if fused:
            _, hist = train.train_on_device(
                *comps, num_particles=16, algorithm="aesmc",
                generative_components=_generative(), num_timesteps=6,
                batch_size=4, num_steps=6, optimizer=optimizer, noise=noise,
                steps_per_call=4, resampling_criterion=0.5)
        else:
            step = train.make_train_step(16, "aesmc", optimizer,
                                         resampling_criterion=0.5)
            hist = []
            for _ in range(6):
                with torch.no_grad():
                    _, obs = statistics.sample_from_prior(
                        *_generative(), 6, 4, noise)
                hist.append(step(comps, obs, noise))
            hist = torch.stack(hist)
        runs.append((hist, train.get_chained_params(*comps),
                     noise.generator.get_state()))
    (hist_a, params_a, gen_a), (hist_b, params_b, gen_b) = runs
    assert torch.equal(hist_a, hist_b)
    for a, b in zip(params_a, params_b):
        assert torch.equal(a, b)
    assert torch.equal(gen_a, gen_b)


def test_default_optimizer_is_adam():
    comps = _learner()
    before = comps[1].mult.item()
    _, hist = train.train_on_device(
        *comps, num_particles=8, algorithm="iwae",
        generative_components=_generative(), num_timesteps=4, batch_size=2,
        num_steps=2, noise=NoiseSource.seeded(0, CPU))
    assert hist.shape == (2,) and torch.isfinite(hist).all()
    assert comps[1].mult.item() != before


def test_cuda_optimizer_without_capturable_raises():
    """The check reads where the optimizer's parameters live: a stand-in
    parameter on the card, in a group built without ``capturable``."""
    on_card = types.SimpleNamespace(device=torch.device("cuda"))
    optimizer = types.SimpleNamespace(param_groups=[
        {"params": [on_card], "capturable": False}])
    with pytest.raises(ValueError, match="capturable=True"):
        train.train_on_device(
            *_learner(), num_particles=8, algorithm="aesmc",
            generative_components=_generative(), num_timesteps=4,
            batch_size=2, num_steps=2, optimizer=optimizer,
            noise=NoiseSource.seeded(0, CPU))
