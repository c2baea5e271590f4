"""The work of the `lgssm` cells' items: a filter call and a served
observation.

Per particle and time step the filter proposes (4 operations: the mean's
multiply-add on the previous particle and the sample's), evaluates three
Gaussian log-densities (transition 6, emission 6, proposal 5), forms the
log-weight (2) and its log-sum-exp (4): `STEP_OPS` = 27. Each
resampling (T - 1 a call) adds the CDF (3), the position (2) and the
search, ceil(log2 K) comparisons. A call reads its `[T, B]` observations
and writes `[B]` log-Z; the particles never need to leave the chip.
"""

from __future__ import annotations

import math

F32 = 4
STEP_OPS = 27
ESS_OPS = 5         # the served step's effective sample size


def _resample_ops(k: int) -> int:
    return 5 + math.ceil(math.log2(k))


def filter_ops(t: int, b: int, k: int) -> int:
    return t * b * k * STEP_OPS + (t - 1) * b * k * _resample_ops(k)


def infer_call(traffic, config) -> tuple:
    t, b, k = (traffic[n] for n in ("num_timesteps", "batch_size",
                                    "num_particles"))
    return filter_ops(t, b, k), F32 * (t * b + b)


def serve_step(traffic, config) -> tuple:
    """One observation: one filter step and the ESS; the carry (particles
    and log-weights, `[B, K]` each) is read and written once, the
    observation read and `log_pred` written."""
    b, k = traffic["batch_size"], traffic["num_particles"]
    ops = b * k * (STEP_OPS + _resample_ops(k) + ESS_OPS)
    return ops, F32 * (4 * b * k + 2 * b)


def k1_shape(traffic, config) -> tuple:
    return traffic["batch_size"], traffic["num_particles"], 1

