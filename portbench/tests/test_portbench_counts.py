"""The counted work against shapes worked out by hand."""

import math

import pytest

from portbench.counts import kernels, lgssm, peaks
from portbench.tests.conftest import load_spec


@pytest.mark.parametrize("shape,nbytes", [
    # CDF 400 KB, values in and out 400 KB each, one uniform a row.
    ((10, 10_000, 1), 4 * (100_000 + 10 + 2 * 100_000)),
    # CDF 262 KB, values in and out 16.8 MB each.
    ((16, 4096, 64), 4 * (65_536 + 16 + 2 * 4_194_304)),
])
def test_k1_bytes(shape, nbytes):
    assert kernels.k1_bytes(*shape) == nbytes


def test_k1_bound_matches_the_kernel_table():
    # The bound of PERF.md's kernel table: 0.358 us at (10, 10,000, 1),
    # 10.1 us at (16, 4,096, 64).
    assert peaks.least_seconds(0, kernels.k1_bytes(10, 10_000, 1)) == \
        pytest.approx(0.358e-6, rel=2e-3)
    assert peaks.least_seconds(0, kernels.k1_bytes(16, 4096, 64)) == \
        pytest.approx(10.1e-6, rel=1e-2)


def _cell(name):
    cell = load_spec().cell(name)
    return cell["traffic"], cell["config_data"]


def test_lgssm_filter_call_by_hand():
    traffic, config = _cell("lgssm-filter")
    ops, nbytes = lgssm.infer_call(traffic, config)
    search = math.ceil(math.log2(10_000))
    assert ops == 200 * 100_000 * 27 + 199 * 100_000 * (5 + search)
    assert nbytes == 4 * (200 * 10 + 10)


def test_lgssm_serve_step_is_bound_by_its_carry():
    traffic, config = _cell("lgssm-serve")
    ops, nbytes = lgssm.serve_step(traffic, config)
    assert nbytes == 4 * (4 * 640_000 + 128)
    assert peaks.least_seconds(ops, nbytes) == nbytes / peaks.HBM_BYTES_PER_S
