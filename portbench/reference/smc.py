"""Plain SMC pieces the references share: the Gaussian log-density,
systematic resampling and one step's log-Z term.

Plain PyTorch, any dtype and device. Nothing here imports the program.
"""

from __future__ import annotations

import math

import torch

LOG_2PI = math.log(2.0 * math.pi)


def normal_log_prob(x, loc, scale):
    """Elementwise log N(x; loc, scale^2)."""
    z = (x - loc) / scale
    return -0.5 * z * z - torch.log(torch.as_tensor(scale, dtype=x.dtype,
                                                    device=x.device)) \
        - 0.5 * LOG_2PI


def systematic_ancestors(log_weight, u):
    """Ancestors `[B, K]` of systematic resampling from ``log_weight``
    `[B, K]` and one uniform a row ``u`` `[B, 1]`: slot j takes the first
    particle whose normalized cumulative weight exceeds (u + j) / K.

    Below float32 (the control) the CDF, the positions and the search run
    in float32: slot indices above 256 and a sum of 10,000 weights have no
    bfloat16 form, and a port computing its weights in a lower precision
    would still resample in float32."""
    if torch.finfo(log_weight.dtype).bits < 32:
        log_weight, u = log_weight.float(), u.float()
    k = log_weight.shape[-1]
    cdf = torch.cumsum(torch.softmax(log_weight, dim=-1), dim=-1)
    slots = torch.arange(k, device=log_weight.device, dtype=log_weight.dtype)
    positions = (u + slots) / k
    idx = torch.searchsorted(cdf.contiguous(), positions.contiguous(),
                             right=True)
    return idx.clamp_(max=k - 1)


def gather_rows(value, idx):
    """``value[b, idx[b, j], ...]``: the resampled particles, with the
    gradient flowing to the values only."""
    index = idx.reshape(idx.shape + (1,) * (value.dim() - 2))
    return torch.gather(value, 1, index.expand(idx.shape + value.shape[2:]))


def log_mean_exp(log_weight):
    """One step's log-Z term `[B]`: log (1/K) sum_k exp(w_k)."""
    return torch.logsumexp(log_weight, dim=-1) - math.log(
        log_weight.shape[-1])
