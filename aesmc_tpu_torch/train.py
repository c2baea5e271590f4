"""Training loop, synthetic data and the on-device loop.

Counterpart of `aesmc_tpu.train`: a `train` loop over a dataloader with
a per-iteration callback and optional checkpoints, parameter discovery
across the four model components, a train step built once by
`make_train_step`, an infinite synthetic dataset that samples fresh
observations from the generative model at every iteration, and
`train_on_device`, which draws the observations and runs the step with
no host round trip: on the card one step (sampling, loss, backward pass,
optimizer step) is captured in a CUDA graph and replayed, the
counterpart of the JAX package's fused `lax.scan`.

The components are `nn.Module`s (or None, or callables without
parameters) and a `torch.optim` optimizer updates their parameters in
place, where the JAX package returns new component pytrees. The callback
contract `(epoch_idx, epoch_iteration_idx, loss, initial, transition,
emission, proposal)` is the same; the callback sees the updated modules.
"""

from __future__ import annotations

import pathlib
from typing import Callable, Iterable, Optional

import torch
from torch import nn

from . import checkpoint, inference, losses, statistics
from .noise import NoiseSource

# Steps `train_on_device` runs eagerly, on a side stream, before it
# captures the step: they build the kernels, create the optimizer's state
# and run autograd once, none of which may happen inside a capture.
WARMUP_STEPS = 3


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
                    resampling_criterion="always",
                    soft_resampling_alpha: float = 0.5,
                    remat: bool = False,
                    nan_check: bool = False,
                    with_metrics: bool = False,
                    **loss_kwargs) -> Callable:
    """Builds ``step(components, observations, noise)``: one optimization
    step (loss, backward pass, ``optimizer.step()``) on the parameters
    ``optimizer`` holds.

    ``components`` is the tuple (initial, transition, emission, proposal);
    None entries are allowed (no transition for T = 1 models). ``noise``
    is the step's `NoiseSource`; draw fresh noise for every step. The step
    returns the loss as a detached device scalar and never waits for the
    device; with ``with_metrics`` it returns (loss, {'elbo', 'ess',
    'grad_norm'}), all device scalars.

    With ``nan_check`` the step reads the NaN guard's flag after the
    backward pass (one wait for the device a step): when a resampling
    step saw a NaN log-weight it clears the gradients and raises
    FloatingPointError before ``optimizer.step()``, so the parameters and
    the optimizer's state are left as they were. ``resampling_method``
    may be 'soft' (differentiable resampling at ``soft_resampling_alpha``).
    ``algorithm`` may be 'tmc'. ``loss_kwargs`` go to the objective
    (`losses.get_loss`'s ``gradient_estimator``, ``score_baseline``,
    ``lookahead``, ``history_window``, and TMC's ``pairwise`` and
    ``block_size``).
    """
    def step(components, observations, noise):
        initial, transition, emission, proposal = components
        optimizer.zero_grad(set_to_none=True)
        loss, metrics, has_nan = losses._objective(
            observations, num_particles, algorithm, initial, transition,
            emission, proposal, noise=noise,
            resampling_method=resampling_method,
            resampling_implementation=resampling_implementation,
            resampling_criterion=resampling_criterion,
            soft_resampling_alpha=soft_resampling_alpha, remat=remat,
            nan_check=nan_check, with_metrics=with_metrics, **loss_kwargs)
        loss.backward()
        if has_nan is not None and bool(has_nan):
            optimizer.zero_grad(set_to_none=True)
            inference._raise_if_nan(has_nan)
        if with_metrics:
            metrics["grad_norm"] = _global_norm(
                [p for group in optimizer.param_groups
                 for p in group["params"]])
        optimizer.step()
        loss = loss.detach()
        return (loss, metrics) if with_metrics else loss

    return step


def _default_optimizer(components, **kwargs):
    """Adam over the components' parameters (lr 1e-3 unless ``kwargs``
    say otherwise), capturable when they are on the card."""
    params = get_chained_params(*components)
    if params is None:
        raise ValueError("the components have no trainable parameters")
    kwargs.setdefault("lr", 1e-3)
    if params[0].device.type == "cuda":
        kwargs.setdefault("capturable", True)
    return torch.optim.Adam(params, **kwargs)


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
          resampling_implementation: str = "auto",
          resampling_criterion="always",
          soft_resampling_alpha: float = 0.5,
          remat: bool = False,
          checkpoint_dir=None,
          checkpoint_interval: Optional[int] = None,
          resume: bool = False,
          **loss_kwargs):
    """Trains the four components in place; returns the tuple
    (initial, transition, emission, proposal).

    The default optimizer is `torch.optim.Adam` over
    `get_chained_params(...)`, built with ``optimizer_kwargs`` (lr 1e-3
    unless they say otherwise). ``noise`` defaults to
    `NoiseSource.seeded(0)` on the device of the optimizer's parameters.

    With ``checkpoint_dir`` the training state (components, optimizer,
    noise and step count; see `checkpoint`) is saved there every
    ``checkpoint_interval`` steps, if given, and once at the end. With
    ``resume`` and an existing ``checkpoint_dir`` the state saved there is
    restored into the components, the optimizer and the noise first, and
    the step count continues from it. ``loss_kwargs`` go to
    `make_train_step`.
    """
    components = (initial, transition, emission, proposal)
    if optimizer is None:
        optimizer = _default_optimizer(components,
                                       **dict(optimizer_kwargs or {}))
    if noise is None:
        noise = NoiseSource.seeded(
            0, optimizer.param_groups[0]["params"][0].device)
    global_step = 0
    if (checkpoint_dir is not None and resume and
            pathlib.Path(checkpoint_dir).exists()):
        global_step = checkpoint.restore(checkpoint_dir, checkpoint.TrainState(
            components, optimizer, noise)).step
    step = make_train_step(
        num_particles, algorithm, optimizer,
        resampling_method=resampling_method,
        resampling_implementation=resampling_implementation,
        resampling_criterion=resampling_criterion,
        soft_resampling_alpha=soft_resampling_alpha, remat=remat,
        **loss_kwargs)

    def save():
        checkpoint.save(checkpoint_dir, checkpoint.TrainState(
            components, optimizer, noise, global_step))

    for epoch_idx in range(num_epochs):
        for epoch_iteration_idx, observations in enumerate(dataloader):
            if num_iterations_per_epoch is not None and \
                    epoch_iteration_idx == num_iterations_per_epoch:
                break
            observations = inference.stack_observations(observations)
            loss = step(components, observations, noise)
            global_step += 1
            if callback is not None:
                callback(epoch_idx, epoch_iteration_idx, loss, *components)
            if (checkpoint_dir is not None and checkpoint_interval and
                    global_step % checkpoint_interval == 0):
                save()
    if checkpoint_dir is not None:
        save()
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


def _check_capturable(optimizer) -> None:
    """ValueError when ``optimizer`` holds parameters on the card but was
    built without ``capturable=True``: its step could not be captured."""
    for group in optimizer.param_groups:
        on_card = any(p.device.type == "cuda" for p in group["params"])
        if on_card and group.get("capturable") is False:
            raise ValueError(
                "train_on_device captures the optimizer step in a CUDA "
                "graph: build the optimizer with capturable=True, e.g. "
                "torch.optim.Adam(params, lr=..., capturable=True)")


def _capture(fn: Callable, generator: torch.Generator):
    """Captures one call of ``fn`` in a `torch.cuda.CUDAGraph`; returns the
    graph and what the captured call returned (tensors that each replay
    overwrites). ``generator``, the source of ``fn``'s noise, is
    registered with the graph, so that every replay draws fresh noise from
    it, as the next eager call would. ``fn`` must have been run eagerly
    before (see `_warm_up`); a capture that fails raises."""
    graph = torch.cuda.CUDAGraph()
    if not hasattr(graph, "register_generator_state"):
        raise RuntimeError(
            f"torch {torch.__version__} cannot register a generator with a "
            "CUDA graph (CUDAGraph.register_generator_state)")
    graph.register_generator_state(generator)
    _release_blas_workspaces()
    with torch.cuda.graph(graph):
        out = fn()
    _release_blas_workspaces()
    return graph, out


def _warm_up(fn: Callable, calls: int) -> None:
    """Runs ``fn`` ``calls`` times on a side stream, as PyTorch's recipe for
    capturing a whole network asks before the capture."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(calls):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    _release_blas_workspaces()


def _release_blas_workspaces() -> None:
    """Drops the cuBLAS workspaces PyTorch caches, one a stream (64 MiB
    on an H100) for the life of the process: a step with a matmul (the
    dense resampling route, a D-dim model) would otherwise leave one
    behind on every warm-up stream and capture. A workspace the capture
    needs stays in the graph's own pool. PyTorch's compiled CUDA graphs
    release them the same way around warm-up and capture."""
    torch._C._cuda_clearCublasWorkspaces()


def train_on_device(initial, transition, emission, proposal,
                    num_particles: int, algorithm: str,
                    generative_components, num_timesteps: int,
                    batch_size: int, num_steps: int,
                    optimizer: Optional[torch.optim.Optimizer] = None,
                    noise: Optional[NoiseSource] = None,
                    steps_per_call: int = 100,
                    resampling_method: str = "systematic",
                    resampling_implementation: str = "auto",
                    resampling_criterion="always",
                    soft_resampling_alpha: float = 0.5,
                    remat: bool = False,
                    callback: Optional[Callable] = None,
                    **loss_kwargs):
    """Trains on synthetic observations with no host round trip a step:
    each step samples fresh observations from ``generative_components``
    and runs `make_train_step`'s step on them.

    On the card the first `WARMUP_STEPS` steps run eagerly on a side
    stream; then one step is captured in a CUDA graph, which has no host
    input (the observations are sampled inside it, and the noise source's
    generator is registered with it), and every later step is a replay.
    Each step writes its loss into a device buffer. The optimizer must be
    capturable (``capturable=True`` for Adam; ValueError otherwise), and
    its learning rate is fixed at capture. There is no eager fallback: a
    capture that fails raises. With CPU components and a CPU noise source
    the same steps run eagerly, in the same blocks.

    Args:
        initial, transition, emission, proposal: the components to train.
        generative_components: (initial, transition, emission) the
            observations are drawn from.
        num_timesteps, batch_size: shape of each step's observations.
        num_steps: optimizer steps, warm-up included.
        optimizer: default `torch.optim.Adam` at lr 1e-3 over
            `get_chained_params(...)`, capturable on the card.
        noise: the `NoiseSource` of the observations and the steps;
            default `NoiseSource.seeded(0)` on the card.
        steps_per_call: steps a block; ``callback`` runs once a block, as
            ``callback(steps_done, mean_loss_of_block, components)``, and
            reads the block's losses from the device (the only read).
        resampling_*, soft_resampling_alpha, remat, loss_kwargs: as in
            `make_train_step` ('soft', 'tmc' and score-gradient steps are
            captured too).

    Returns:
        (components, losses `[num_steps]` on the noise source's device).
    """
    components = (initial, transition, emission, proposal)
    if optimizer is None:
        optimizer = _default_optimizer(components)
    _check_capturable(optimizer)
    if noise is None:
        noise = NoiseSource.seeded(0)
    gen_initial, gen_transition, gen_emission = generative_components
    step = make_train_step(
        num_particles, algorithm, optimizer,
        resampling_method=resampling_method,
        resampling_implementation=resampling_implementation,
        resampling_criterion=resampling_criterion,
        soft_resampling_alpha=soft_resampling_alpha, remat=remat,
        **loss_kwargs)
    losses_out = torch.empty((num_steps,), device=noise.device)
    # The next step's index, on the device, so that a replay writes its
    # loss to its own slot.
    next_step = torch.zeros((1,), dtype=torch.long, device=noise.device)

    def one_step():
        with torch.no_grad():
            _, observations = statistics.sample_from_prior(
                gen_initial, gen_transition, gen_emission, num_timesteps,
                batch_size, noise)
        loss = step(components, observations, noise)
        losses_out.index_copy_(0, next_step, loss.reshape(1))
        next_step.add_(1)

    graphed = noise.device.type == "cuda"
    graph = None
    done = 0
    while done < num_steps:
        block = min(steps_per_call, num_steps - done)
        for i in range(done, done + block):
            if not graphed:
                one_step()
            elif i < WARMUP_STEPS:
                _warm_up(one_step, 1)
            else:
                if graph is None:
                    graph, _ = _capture(one_step, noise.generator)
                graph.replay()
        done += block
        if callback is not None:
            callback(done, float(losses_out[done - block:done].mean()),
                     components)
    return components, losses_out
