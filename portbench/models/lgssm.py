"""The `lgssm` configuration as the port runs it, and its data.

Builds `aesmc_tpu_torch.models.lgssm` components from the configuration's
numbers, with the model's optimal proposal, and observations of the data
model drawn on the card in one call a kind.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from aesmc_tpu_torch.models import lgssm


def proposal_params(model) -> dict:
    """The exactly optimal proposal p(x_t | x_{t-1}, y_t) of the model, an
    affine Gaussian of precision 1/q + c^2/r (one Kalman update)."""
    q0, q = model["initial_scale"] ** 2, model["transition_scale"] ** 2
    r, c = model["emission_scale"] ** 2, model["emission_mult"]
    prec_0, prec_t = 1.0 / q0 + c * c / r, 1.0 / q + c * c / r
    return {"lin_0_weight": (c / r) / prec_0,
            "lin_0_bias": (model["initial_loc"] / q0) / prec_0,
            "lin_t_weight": [(model["transition_mult"] / q) / prec_t,
                             (c / r) / prec_t],
            "lin_t_bias": 0.0,
            "proposal_scale_0": math.sqrt(1.0 / prec_0),
            "proposal_scale_t": math.sqrt(1.0 / prec_t)}


def _proposal(p, device):
    return lgssm.Proposal(p["lin_0_weight"], p["lin_0_bias"],
                          p["lin_t_weight"], p["lin_t_bias"],
                          p["proposal_scale_0"],
                          p["proposal_scale_t"]).to(device)


def generative(model, device):
    """(initial, transition, emission) of the data model."""
    return (lgssm.Initial(model["initial_loc"], model["initial_scale"]),
            lgssm.Transition(model["transition_mult"],
                             model["transition_scale"]).to(device),
            lgssm.Emission(model["emission_mult"],
                           model["emission_scale"]).to(device))


def filter_components(model, device):
    """The data model with its optimal proposal, and that proposal's
    numbers (for the reference)."""
    prop = proposal_params(model)
    return generative(model, device) + (_proposal(prop, device),), prop


CHUNK = 64


def ar1(drive, a):
    """x_t = a x_{t-1} + drive_t along axis 0 (x_0 = drive_0), float64:
    each chunk of 64 steps at once (x_i = a^i sum_{j<=i} a^-j d_j, the
    scales within 0.9^-64 < 1e3), then the chunks' carries in turn."""
    n, batch = drive.shape
    chunks = -(-n // CHUNK)
    d = np.zeros((chunks * CHUNK, batch))
    d[:n] = drive
    d = d.reshape(chunks, CHUNK, batch)
    powers = a ** np.arange(CHUNK, dtype=np.float64)[:, None]
    local = np.cumsum(d / powers, axis=1) * powers
    carry = np.zeros(batch)
    for c in range(chunks):
        local[c] += a * carry * powers
        carry = local[c, -1]
    return local.reshape(-1, batch)[:n]


def observations(model, generator, num_timesteps, batch):
    """`[T, B]` float32 observations of the data model on the generator's
    device, from two normal draws made there in one call each; the
    recursion x_t = a x_{t-1} + e_t runs on the host in float64."""
    shape = (num_timesteps, batch)
    e_x = torch.randn(shape, generator=generator, device=generator.device,
                      dtype=torch.float32)
    e_y = torch.randn(shape, generator=generator, device=generator.device,
                      dtype=torch.float32)
    drive = e_x.double().cpu().numpy() * model["transition_scale"]
    drive[0] = (model["initial_loc"] +
                model["initial_scale"] * drive[0] / model["transition_scale"])
    x = ar1(drive, model["transition_mult"])
    y = model["emission_mult"] * x + model["emission_scale"] * \
        e_y.double().cpu().numpy()
    return torch.from_numpy(y.astype(np.float32)).to(generator.device)
