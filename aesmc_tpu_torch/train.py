"""Training loop and synthetic data.

Counterpart of `aesmc_tpu.train`: a `train` loop over a dataloader with
a per-iteration callback, parameter discovery across the four model
components, a train step built once by `make_train_step`, and an infinite
synthetic dataset that samples fresh observations from the generative
model at every iteration.

The components are `nn.Module`s (or None, or callables without
parameters) and a `torch.optim` optimizer updates their parameters in
place, where the JAX package returns new component pytrees. The callback
contract `(epoch_idx, epoch_iteration_idx, loss, initial, transition,
emission, proposal)` is the same; the callback sees the updated modules.

Not ported yet: `train_on_device` (the fused on-device loop, whose
counterpart is a CUDA graph) and checkpointing (`checkpoint.py`).
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional

import torch
from torch import nn

from . import inference, losses, statistics
from .noise import NoiseSource


def get_chained_params(*objects):
    """The parameters of every `nn.Module` among ``objects``, each once,
    in order; None when there are none."""
    params, seen = [], set()
    for obj in objects:
        if isinstance(obj, nn.Module):
            for p in obj.parameters():
                if id(p) not in seen:
                    seen.add(id(p))
                    params.append(p)
    return params or None


def _global_norm(params):
    norms = [torch.linalg.vector_norm(p.grad) for p in params
             if p.grad is not None]
    if not norms:
        return torch.zeros(())
    return torch.linalg.vector_norm(torch.stack(norms))


def make_train_step(num_particles: int, algorithm: str,
                    optimizer: torch.optim.Optimizer,
                    resampling_method: str = "systematic",
                    resampling_implementation: str = "auto",
                    with_metrics: bool = False,
                    nan_check: bool = False) -> Callable:
    """Builds ``step(components, observations, noise)``: one optimization
    step (loss, backward pass, ``optimizer.step()``) on the parameters
    ``optimizer`` holds.

    ``components`` is the tuple (initial, transition, emission, proposal);
    None entries are allowed (no transition for T = 1 models). ``noise``
    is the step's `NoiseSource`; draw fresh noise for every step. The step
    returns the loss as a detached device scalar and never waits for the
    device; with ``with_metrics`` it returns (loss, {'elbo', 'ess',
    'grad_norm'}), all device scalars.
    """
    def step(components, observations, noise):
        initial, transition, emission, proposal = components
        optimizer.zero_grad(set_to_none=True)
        args = (observations, num_particles, algorithm, initial, transition,
                emission, proposal)
        kwargs = dict(noise=noise, resampling_method=resampling_method,
                      resampling_implementation=resampling_implementation,
                      nan_check=nan_check)
        if with_metrics:
            loss, metrics = losses.get_loss_and_metrics(*args, **kwargs)
        else:
            loss = losses.get_loss(*args, **kwargs)
        loss.backward()
        if with_metrics:
            metrics["grad_norm"] = _global_norm(
                [p for group in optimizer.param_groups
                 for p in group["params"]])
        optimizer.step()
        loss = loss.detach()
        return (loss, metrics) if with_metrics else loss

    return step


def train(dataloader: Iterable,
          num_particles: int,
          algorithm: str,
          initial,
          transition,
          emission,
          proposal,
          num_epochs: int,
          num_iterations_per_epoch: Optional[int] = None,
          optimizer: Optional[torch.optim.Optimizer] = None,
          optimizer_kwargs: Optional[dict] = None,
          callback: Optional[Callable] = None,
          noise: Optional[NoiseSource] = None,
          resampling_method: str = "systematic",
          resampling_implementation: str = "auto"):
    """Trains the four components in place; returns the tuple
    (initial, transition, emission, proposal).

    The default optimizer is `torch.optim.Adam` over
    `get_chained_params(...)`, built with ``optimizer_kwargs`` (lr 1e-3
    unless they say otherwise). ``noise`` defaults to
    `NoiseSource.seeded(0)` on the device of the first observations.
    """
    components = (initial, transition, emission, proposal)
    if optimizer is None:
        params = get_chained_params(*components)
        if params is None:
            raise ValueError("the components have no trainable parameters")
        kwargs = dict(optimizer_kwargs or {})
        kwargs.setdefault("lr", 1e-3)
        optimizer = torch.optim.Adam(params, **kwargs)
    step = make_train_step(
        num_particles, algorithm, optimizer,
        resampling_method=resampling_method,
        resampling_implementation=resampling_implementation)

    for epoch_idx in range(num_epochs):
        for epoch_iteration_idx, observations in enumerate(dataloader):
            if num_iterations_per_epoch is not None and \
                    epoch_iteration_idx == num_iterations_per_epoch:
                break
            observations = inference.stack_observations(observations)
            if noise is None:
                noise = NoiseSource.seeded(
                    0, inference._first_leaf(observations).device)
            loss = step(components, observations, noise)
            if callback is not None:
                callback(epoch_idx, epoch_iteration_idx, loss, *components)
    return components


class SyntheticDataLoader:
    """Infinite iterable of synthetic observations: each iteration yields
    fresh stacked `[T, batch, ...]` observations sampled from the
    generative model (without gradient), on the device of ``noise``
    (default `NoiseSource.seeded(0)` on the card)."""

    def __init__(self, initial, transition, emission, num_timesteps: int,
                 batch_size: int, noise: Optional[NoiseSource] = None):
        self.initial = initial
        self.transition = transition
        self.emission = emission
        self.num_timesteps = num_timesteps
        self.batch_size = batch_size
        self.noise = noise if noise is not None else NoiseSource.seeded(0)

    def __iter__(self):
        while True:
            # Grad mode is restored before the yield, so the consumer's
            # training step runs with gradients on.
            with torch.no_grad():
                _, observations = statistics.sample_from_prior(
                    self.initial, self.transition, self.emission,
                    self.num_timesteps, self.batch_size, self.noise)
            yield observations


def get_synthetic_dataloader(initial, transition, emission,
                             num_timesteps: int, batch_size: int,
                             noise: Optional[NoiseSource] = None
                             ) -> SyntheticDataLoader:
    """The `SyntheticDataLoader` of the generative model."""
    return SyntheticDataLoader(initial, transition, emission, num_timesteps,
                               batch_size, noise)
