"""The port's per-time-step weighted statistics against the JAX package.

`empirical_mean_sequence` and `empirical_variance_sequence` on stacked
`[T, batch, particle, ...]` values and one `[batch, particle]` weight
tensor made from a numpy seed, with and without event dimensions and
with -inf log-weights; values agree within 1e-5 (float32 sums in other
orders).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aesmc_tpu import statistics as jax_statistics
from aesmc_tpu_torch import statistics


@pytest.mark.parametrize("shape", [(6, 3, 5), (4, 2, 7, 3)])
@pytest.mark.parametrize("name", ["empirical_mean_sequence",
                                  "empirical_variance_sequence"])
def test_sequence_statistics_match_jax(name, shape):
    rng = np.random.RandomState(len(shape))
    values = rng.randn(*shape).astype(np.float32) * 2
    log_weight = rng.randn(*shape[1:3]).astype(np.float32) * 3
    log_weight[0, 1] = -np.inf
    want = np.asarray(getattr(jax_statistics, name)(
        jnp.asarray(values), jnp.asarray(log_weight)))
    got = getattr(statistics, name)(torch.tensor(values),
                                    torch.tensor(log_weight))
    assert tuple(got.shape) == want.shape == shape[:2] + shape[3:]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
