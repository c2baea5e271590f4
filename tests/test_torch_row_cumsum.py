"""Every float scan over the particle axis goes through
`resampling._row_cumsum`, which on the card scans a one-row tensor in two
levels (`_two_level_cumsum`): PyTorch hands one row on a card to CUB's
single-pass scan, whose float32 sums vary from run to run, so the same
noise could draw other ancestors.

Each of the five call sites (SQMC's sorted CDF, the conditional ancestors'
spacings, the residual CDF, the rejection smoother's proposal table and the
forecast quantiles) is run at B = 1 with `_row_cumsum` spied: it must see
the one-row scan, and with the spy taking the card's two-level route the
results must stay those of the CPU's `torch.cumsum` (CDF values within
1e-6, indices equal). Without the spy the CPU route is `torch.cumsum`
itself, so every CPU parity test is unchanged.
"""

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (caps PyTorch's threads)
from aesmc_tpu_torch import csmc, forecast, resampling, smoothing, sqmc
from aesmc_tpu_torch.noise import NoiseSource

K = 700          # two chunks of the two-level scan
CPU = torch.device("cpu")


def _log_weight(seed):
    return torch.tensor(np.random.RandomState(seed).randn(1, K),
                        dtype=torch.float32)


def _sites():
    """name -> a call of the site at B = 1 from a fixed seed."""
    lw = _log_weight(0)
    sigma = torch.tensor(np.random.RandomState(1).permutation(K)[None],
                         dtype=torch.int32)
    values = torch.tensor(np.random.RandomState(2).randn(1, K),
                          dtype=torch.float32)
    return {
        "sqmc._sorted_cdf": lambda: sqmc._sorted_cdf(lw, sigma),
        "csmc._conditional_ancestors": lambda: csmc._conditional_ancestors(
            lw, NoiseSource.seeded(3, CPU)),
        "resampling.residual_indices": lambda: resampling.residual_indices(
            lw, NoiseSource.seeded(4, CPU)),
        "smoothing._weights_cdf": lambda: smoothing._weights_cdf(lw),
        "forecast.weighted_quantiles": lambda: forecast.weighted_quantiles(
            values, lw, (0.05, 0.5, 0.95)),
    }


@pytest.mark.parametrize("site", sorted(_sites()))
def test_site_scans_through_row_cumsum(monkeypatch, site):
    plain = _sites()[site]()
    seen = []

    def card_route(x):
        # The route `_row_cumsum` takes for one row on a card.
        seen.append(tuple(x.shape))
        if x.shape[0] == 1:
            return resampling._two_level_cumsum(x)
        return torch.cumsum(x, dim=-1)

    monkeypatch.setattr(resampling, "_row_cumsum", card_route)
    two_level = _sites()[site]()
    assert any(shape[0] == 1 and shape[1] >= K for shape in seen), seen
    if plain.is_floating_point() and site != "forecast.weighted_quantiles":
        torch.testing.assert_close(two_level, plain, rtol=0, atol=1e-6)
    else:
        assert torch.equal(two_level, plain)


def test_cpu_route_is_torch_cumsum():
    x = _log_weight(5).exp()
    assert torch.equal(resampling._row_cumsum(x), torch.cumsum(x, dim=-1))
