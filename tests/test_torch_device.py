"""The port's entry points default to the card, with no quiet fallback to
the CPU: without a card their defaults raise, and a caller reaches the CPU
only by asking for it (`device="cpu"`, or CPU tensors)."""

import numpy as np
import pytest
import torch

from aesmc_tpu_torch import device, inference, statistics, train
from aesmc_tpu_torch.models import gaussian, lgssm
from aesmc_tpu_torch.noise import NoiseSource
import torch_threads  # noqa: F401  (caps PyTorch's threads)

LGSSM_PARAMS = {
    "initial": {"loc": 0.0, "scale": 1.0},
    "transition": {"mult": 0.9, "scale": 1.0},
    "emission": {"mult": 1.0, "scale": 0.5},
    "proposal": {"lin_0_weight": 0.5, "lin_0_bias": 0.0,
                 "lin_t_weight": [0.5, 0.5], "lin_t_bias": 0.0,
                 "scale_0": 1.0, "scale_t": 1.0},
}
GAUSSIAN_PARAMS = {
    "prior": {"mean": 0.0, "std": 1.0},
    "likelihood": {"log_std": 0.0},
    "inference_network": {"mult": 0.5, "bias": 0.0, "log_std": 0.0},
}


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the defaults run on it")


def test_default_device_is_the_card():
    assert device.default_device() == torch.device("cuda")
    assert device.resolve("cpu") == torch.device("cpu")


def test_defaults_raise_without_a_card():
    _no_card()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        device.resolve()
    with pytest.raises(RuntimeError, match="no CUDA card"):
        NoiseSource.seeded(0)
    comps = lgssm.from_numpy(LGSSM_PARAMS, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        statistics.sample_from_prior(*comps[:3], 3, 2)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        lgssm.from_numpy(LGSSM_PARAMS)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        gaussian.from_numpy(GAUSSIAN_PARAMS)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        train.get_synthetic_dataloader(*comps[:3], 3, 2)
    obs = np.zeros((3, 2), np.float32)
    for observations in (obs, list(obs)):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            inference.infer("smc", observations, *comps, 4)


def test_cpu_on_request():
    comps = lgssm.from_numpy(LGSSM_PARAMS, device="cpu")
    assert all(p.device.type == "cpu" for c in comps for p in c.parameters())
    noise = NoiseSource.seeded(0, device="cpu")
    assert noise.device.type == "cpu"
    assert noise.exponential((2, 3)).min() >= 0
    _, obs = statistics.sample_from_prior(*comps[:3], 3, 2, noise)
    # A tensor stays where the caller put it, and the default noise
    # follows it.
    out = inference.infer("smc", obs.detach(), *comps, 4,
                          return_log_marginal_likelihood=True)
    assert out["log_marginal_likelihood"].device.type == "cpu"
    stacked = inference.stack_observations(list(obs.detach().numpy()),
                                           device="cpu")
    assert stacked.device.type == "cpu"
