"""Checkpoint and resume in the port.

Ports `tests/test_train.py::TestTrainCheckpointing` (train with a
checkpoint directory, then resume with no iterations: the parameters
continue from the saved state), and holds a resumed run to an
uninterrupted one: 5 steps, a save, and 5 more steps after a resume
equal 10 steps in one run bit for bit, Adam's state and the noise
generator's state included.
"""

import numpy as np
import pytest
import torch

from aesmc_tpu_torch import checkpoint, train
from aesmc_tpu_torch.models import lgssm
from aesmc_tpu_torch.noise import NoiseSource

CPU = "cpu"


def _learner():
    return (lgssm.Initial(0.0, 1.0), lgssm.Transition(0.0, 1.0),
            lgssm.Emission(0.5, 0.2),
            lgssm.Proposal.create(1.0, 1.0,
                                  torch.Generator().manual_seed(0)))


def _batches(n):
    """``n`` batches of observations [5, 4] from the true model."""
    loader = iter(train.get_synthetic_dataloader(
        lgssm.Initial(0.0, 1.0), lgssm.Transition(0.9, 1.0),
        lgssm.Emission(1.0, 0.2), 5, 4, NoiseSource.seeded(0, CPU)))
    return [next(loader) for _ in range(n)]


def test_checkpoint_and_resume(tmp_path):
    loader = train.get_synthetic_dataloader(
        lgssm.Initial(0.0, 1.0), lgssm.Transition(0.9, 1.0),
        lgssm.Emission(1.0, 0.2), 5, 4, NoiseSource.seeded(0, CPU))
    ckpt_dir = tmp_path / "run1"
    comps = train.train(loader, 8, "aesmc", *_learner(), num_epochs=1,
                        num_iterations_per_epoch=5,
                        noise=NoiseSource.seeded(1, CPU),
                        checkpoint_dir=ckpt_dir)
    assert ckpt_dir.exists()
    comps2 = train.train(loader, 8, "aesmc", *_learner(), num_epochs=1,
                         num_iterations_per_epoch=0,
                         noise=NoiseSource.seeded(1, CPU),
                         checkpoint_dir=ckpt_dir, resume=True)
    np.testing.assert_allclose(comps2[1].mult.item(), comps[1].mult.item(),
                               rtol=1e-6)


def test_resumed_run_equals_uninterrupted(tmp_path):
    batches = _batches(10)

    def run(data, noise, **kwargs):
        comps = _learner()
        optimizer = torch.optim.Adam(train.get_chained_params(*comps),
                                     lr=1e-2)
        train.train(data, 8, "aesmc", *comps, num_epochs=1,
                    optimizer=optimizer, noise=noise, **kwargs)
        return comps, optimizer, noise

    whole = run(batches, NoiseSource.seeded(1, CPU))
    ckpt_dir = tmp_path / "run"
    run(batches[:5], NoiseSource.seeded(1, CPU), checkpoint_dir=ckpt_dir)
    # A fresh process would start from other values: resume must restore
    # all of them.
    resumed = run(batches[5:], NoiseSource.seeded(99, CPU),
                  checkpoint_dir=ckpt_dir, resume=True)

    for a, b in zip(train.get_chained_params(*whole[0]),
                    train.get_chained_params(*resumed[0])):
        assert torch.equal(a, b)
    state_a, state_b = whole[1].state_dict(), resumed[1].state_dict()
    for i, state in state_a["state"].items():
        for name, value in state.items():
            assert torch.equal(value, state_b["state"][i][name]), name
    assert torch.equal(whole[2].generator.get_state(),
                       resumed[2].generator.get_state())
    saved = torch.load(ckpt_dir / checkpoint.FILE, weights_only=True)
    assert saved["step"] == 10
    assert [p.name for p in ckpt_dir.iterdir()] == [checkpoint.FILE]


def test_interval_and_restore(tmp_path, monkeypatch):
    """Saves every `checkpoint_interval` steps and at the end; `restore`
    loads into the template's objects and returns it with the step."""
    steps_seen = []
    save = checkpoint.save

    def spy(path, state):
        steps_seen.append(state.step)
        save(path, state)

    monkeypatch.setattr(checkpoint, "save", spy)
    comps = _learner()
    optimizer = torch.optim.Adam(train.get_chained_params(*comps), lr=1e-2)
    noise = NoiseSource.seeded(1, CPU)
    train.train(_batches(5), 8, "aesmc", *comps, num_epochs=1,
                optimizer=optimizer, noise=noise, checkpoint_dir=tmp_path,
                checkpoint_interval=2)
    assert steps_seen == [2, 4, 5]

    fresh = _learner()
    template = checkpoint.TrainState(
        fresh, torch.optim.Adam(train.get_chained_params(*fresh), lr=1e-2),
        NoiseSource.seeded(5, CPU))
    restored = checkpoint.restore(tmp_path, template)
    assert restored is template and restored.step == 5
    assert torch.equal(fresh[1].mult, comps[1].mult)
    assert torch.equal(template.noise.generator.get_state(),
                       noise.generator.get_state())
    bad = checkpoint.TrainState(_learner()[:3], optimizer, noise)
    with pytest.raises(ValueError, match="components"):
        checkpoint.restore(tmp_path, bad)
