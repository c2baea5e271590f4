"""A tensor handed to a model component is kept as given: the
counterpart of the JAX struct fields that hold any array (`mult: Any`,
`aesmc_tpu/models/lgssm.py:50`).

`lgssm.Transition`/`Emission`, `gaussian`'s and `bouncing_ball`'s
`_param`: a tensor keeps its device (the `meta` device here stands for a
card: the old copy through numpy raised there), its dtype and its
autograd graph (the old copy raised on a tensor that requires grad), is
not a registered parameter and is not moved by `.to()`; a `[B, K]` tensor
broadcasts against `[B, K]` latents. A number or numpy array still
becomes a float32 `nn.Parameter`.
"""

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (caps PyTorch's threads)
from aesmc_tpu_torch.models import bouncing_ball, gaussian, lgssm

META = torch.device("meta")


@pytest.mark.parametrize("make", [
    lambda x: lgssm.Transition(mult=x, scale=1.0),
    lambda x: lgssm.Emission(mult=x, scale=0.5)])
def test_lgssm_keeps_a_meta_tensor(make):
    mult = torch.empty((3, 5), device=META)
    module = make(mult)
    assert module.mult is mult
    assert list(module.parameters()) == []
    latent = torch.empty((3, 5), device=META)
    if isinstance(module, lgssm.Transition):
        dist = module(previous_latents=[latent])
    else:
        dist = module(latents=[latent])
    assert dist.loc.device == META and tuple(dist.loc.shape) == (3, 5)


def test_lgssm_keeps_the_graph():
    mult = torch.full((2, 4), 0.9, requires_grad=True)
    transition = lgssm.Transition(mult=mult, scale=1.0)
    latent = torch.randn(2, 4, generator=torch.Generator().manual_seed(0))
    lp = transition(previous_latents=[latent]).log_prob(latent * 0.5).sum()
    lp.backward()
    assert transition.mult is mult and mult.grad is not None
    # .to() moves registered parameters and buffers, not a kept tensor.
    assert transition.to(torch.float64).mult is mult


def test_numbers_still_become_parameters():
    transition = lgssm.Transition(mult=0.9, scale=1.0)
    assert isinstance(transition.mult, torch.nn.Parameter)
    assert transition.mult.dtype == torch.float32
    assert [p is transition.mult for p in transition.parameters()] == [True]
    emission = lgssm.Emission(mult=np.float64(1.5), scale=0.5)
    assert isinstance(emission.mult, torch.nn.Parameter)
    assert float(emission.mult.detach()) == 1.5


@pytest.mark.parametrize("param", [gaussian._param, bouncing_ball._param])
def test_gaussian_and_bouncing_ball_param(param):
    meta = torch.empty((4,), device=META)
    assert param(meta) is meta
    graph = torch.zeros((), requires_grad=True) * 2.0
    assert param(graph) is graph and graph.requires_grad
    number = param(0.25)
    assert isinstance(number, torch.nn.Parameter)
    assert number.dtype == torch.float32 and float(number.detach()) == 0.25
