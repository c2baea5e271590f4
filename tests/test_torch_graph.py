"""`train.train_on_device`'s CUDA graph, on the card only.

Marked `cuda`: without a card the test skips. It imports nothing of JAX,
so that it runs where the card is (the repository's `conftest.py`
imports JAX, hence `--noconftest`):

    python -m pytest --noconftest -o addopts= tests/test_torch_graph.py

8 steps, 3 of them the warm-up and 5 graph replays, equal 8 eager
`make_train_step` steps from the same seed bit for bit, and with lr 0
every replay draws fresh noise (every replay's loss differs).
"""

import pytest
import torch

from aesmc_tpu_torch import statistics, train
from aesmc_tpu_torch.models import lgssm
from aesmc_tpu_torch.noise import NoiseSource

T, B, K, STEPS = 5, 2, 16, 8


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the step is captured in a CUDA "
                    "graph only on the card")
    return torch.device("cuda", 0)


def _run(dev, fused, lr):
    comps = tuple(m.to(dev) for m in (
        lgssm.Initial(0.0, 1.0), lgssm.Transition(0.0, 1.0),
        lgssm.Emission(0.3, 0.1),
        lgssm.Proposal.create(1.0, 1.0, torch.Generator().manual_seed(0))))
    generative = tuple(m.to(dev) for m in (
        lgssm.Initial(0.0, 1.0), lgssm.Transition(0.9, 1.0),
        lgssm.Emission(1.0, 0.1)))
    optimizer = torch.optim.Adam(train.get_chained_params(*comps), lr=lr,
                                 capturable=True)
    noise = NoiseSource.seeded(5, dev)
    if fused:
        return train.train_on_device(
            *comps, K, "aesmc", generative, T, B, STEPS, optimizer=optimizer,
            noise=noise, steps_per_call=4)[1]
    step = train.make_train_step(K, "aesmc", optimizer)
    losses = []
    for _ in range(STEPS):
        with torch.no_grad():
            _, obs = statistics.sample_from_prior(*generative, T, B, noise)
        losses.append(step(comps, obs, noise))
    return torch.stack(losses)


@pytest.mark.cuda
def test_graphed_steps_equal_eager(card):
    assert torch.equal(_run(card, True, 1e-2), _run(card, False, 1e-2))
    replays = _run(card, True, 0.0)[train.WARMUP_STEPS:].tolist()
    assert len(set(replays)) == len(replays)
