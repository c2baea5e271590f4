"""The end-to-end arithmetic: all of the window, every sample."""

import statistics

import pytest

from portbench.harness import stats


def test_window_rate_over_all_steps():
    # 37 steps in 2.5 s: every step and all of the time, not a mean of
    # per-block rates.
    assert stats.per_item_ms(2.5, 37) == pytest.approx(2500 / 37)
    with pytest.raises(ValueError):
        stats.per_item_ms(1.0, 0)


def test_p95_over_all_samples_not_chunk_medians():
    # 94 fast samples and 6 slow ones, one in each of six chunks of 10:
    # every chunk's median is fast, so a p95 of chunk medians would hide
    # the tail that the p95 of all samples shows.
    samples = [1.0] * 100
    for chunk in range(6):
        samples[10 * chunk + 3] = 9.0
    chunk_medians = [statistics.median(samples[i:i + 10])
                     for i in range(0, 100, 10)]
    assert stats.percentile(chunk_medians, 95) == 1.0
    assert stats.percentile(samples, 95) == 9.0
    assert stats.percentile(samples, 94) == 1.0


@pytest.mark.parametrize("q,expected", [(50, 50), (95, 95), (100, 100),
                                        (1, 1)])
def test_nearest_rank(q, expected):
    assert stats.percentile(list(range(100, 0, -1)), q) == expected


def test_spread_uses_statistics_quantiles():
    values = [10.0, 10.2, 9.9, 10.1, 10.4, 9.8]
    q1, q2, q3 = statistics.quantiles(values, n=4)
    assert stats.spread(values) == pytest.approx((q3 - q1) / q2)

