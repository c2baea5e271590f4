"""Checkpoint and resume of a training run.

Counterpart of `aesmc_tpu.checkpoint` (orbax there): the training state
is the components (`nn.Module`s), the optimizer, the noise source and the
step count, and it is written as one `torch.save` file:

    state = TrainState(components, optimizer, noise, step)
    checkpoint.save(path, state)
    state = checkpoint.restore(path, state)   # loads into state's objects

`restore` loads in place, into the objects of the state it is given, the
way `load_state_dict` does, where the JAX package builds new pytrees from
a template.
"""

from __future__ import annotations

import dataclasses
import os
import pathlib

import torch
from torch import nn

from .noise import NoiseSource

# The file `save` writes into its directory.
FILE = "train_state.pt"


@dataclasses.dataclass
class TrainState:
    components: tuple   # (initial, transition, emission, proposal)
    optimizer: torch.optim.Optimizer
    noise: NoiseSource
    step: int = 0


def save(path, state: TrainState, force: bool = True) -> None:
    """Writes ``state`` into the directory ``path`` (made if missing): the
    `state_dict` of each `nn.Module` component (None for the others), the
    optimizer's `state_dict`, the noise generator's state and the step.
    The file is written under a temporary name and renamed over the old
    one, so that a crash leaves the previous checkpoint whole. With
    ``force=False`` an existing ``path`` raises ValueError, as the JAX
    package's checkpointer does; by default it is overwritten."""
    path = pathlib.Path(path)
    if not force and path.exists():
        raise ValueError(f"Destination {path.absolute()} already exists.")
    path.mkdir(parents=True, exist_ok=True)
    payload = {
        "components": [c.state_dict() if isinstance(c, nn.Module) else None
                       for c in state.components],
        "optimizer": state.optimizer.state_dict(),
        "noise": state.noise.generator.get_state(),
        "step": int(state.step),
    }
    tmp = path / f".{FILE}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path / FILE)


def restore(path, template: TrainState) -> TrainState:
    """Loads the state `save` wrote in ``path`` into ``template``'s
    components, optimizer and noise generator, sets its step, and returns
    it. The file is read with ``weights_only=True``."""
    payload = torch.load(pathlib.Path(path) / FILE, map_location="cpu",
                         weights_only=True)
    saved = payload["components"]
    if len(saved) != len(template.components):
        raise ValueError(f"the checkpoint holds {len(saved)} components, "
                         f"the template {len(template.components)}")
    for component, state_dict in zip(template.components, saved):
        if (state_dict is None) != (not isinstance(component, nn.Module)):
            raise ValueError("the checkpoint's components do not match the "
                             "template's: a module where there is none")
        if state_dict is not None:
            component.load_state_dict(state_dict)
    template.optimizer.load_state_dict(payload["optimizer"])
    template.noise.generator.set_state(payload["noise"])
    template.step = payload["step"]
    return template
