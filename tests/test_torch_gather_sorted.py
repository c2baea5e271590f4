"""The port's gather by sorted indices (K5) and the dtype split of
resampling against the JAX package.

On the CPU the port's wrapper runs its plain version (take_along_dim); the
JAX side runs `gather_sorted_pallas` through the Pallas interpreter, or
numpy for the dtypes the TPU kernel does not carry. Float32 particles ride
K1/K3 and every other dtype goes to K5 with the same indices, so a mixed
`{int32, float32}` value comes out of `sample_ancestral_index_and_resample`
bit-equal to the JAX package's Pallas route (integers through its 16-bit
pair transport) when both search the same CDF.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aesmc_tpu import resampling as jax_resampling
from aesmc_tpu.ops import gather_pallas, resample_pallas
from aesmc_tpu_torch import resampling
from aesmc_tpu_torch.ops import gather_sorted_cuda
from torch_replay import ReplayNoise, tensor as _t


def _sorted_indices(rng, batch, k, kp):
    return np.sort(rng.integers(0, k, size=(batch, kp)),
                   axis=1).astype(np.int32)


def _jax_cdf(log_weight):
    return _t(jax_resampling._normalized_cumsum(
        jnp.asarray(log_weight.detach().numpy())))


@pytest.mark.parametrize("d", [1, 3, 16])
def test_plain_gather_matches_pallas_float32(d):
    rng = np.random.default_rng(d)
    batch, k = 2, 700
    value = rng.normal(size=(batch, k, d)).astype(np.float32)
    idx = _sorted_indices(rng, batch, k, k)
    idx[0] = 5                                  # all-equal indices
    want = np.asarray(gather_pallas.gather_sorted_pallas(
        jnp.asarray(value), jnp.asarray(idx), interpret=True))
    got = gather_sorted_cuda.gather_sorted(_t(value), _t(idx))
    assert got.dtype == torch.float32 and got.shape == (batch, k, d)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", ["int32", "int64", "int8", "bool",
                                   "float64"])
@pytest.mark.parametrize("trailing", [(), (3,), (2, 2)])
def test_plain_gather_matches_numpy(dtype, trailing):
    rng = np.random.default_rng(7)
    batch, k, kp = 3, 257, 300
    raw = rng.integers(-2 ** 31, 2 ** 31, size=(batch, k) + trailing)
    if dtype == "bool":
        value = raw > 0
    elif dtype == "float64":
        value = rng.normal(size=(batch, k) + trailing)
    else:
        value = raw.astype(dtype)
    idx = _sorted_indices(rng, batch, k, kp)
    want = np.take_along_axis(
        value, idx.reshape(idx.shape + (1,) * len(trailing)).astype(np.int64),
        axis=1)
    got = gather_sorted_cuda.gather_sorted(_t(value), _t(idx))
    assert got.dtype == _t(value).dtype
    assert got.shape == (batch, kp) + trailing
    np.testing.assert_array_equal(got.numpy(), want)


def test_wrapper_checks_inputs_and_counts_no_cpu_launch():
    value = torch.arange(12, dtype=torch.int32).reshape(2, 6)
    idx = torch.tensor([[0, 0, 5], [1, 2, 9]], dtype=torch.int32)
    before = gather_sorted_cuda.LAUNCHES
    got = gather_sorted_cuda.gather_sorted(value, idx)
    assert gather_sorted_cuda.LAUNCHES == before
    # Indices are clamped into [0, K - 1].
    assert got.tolist() == [[0, 0, 5], [7, 8, 11]]
    bad = [
        (value, idx.long(), TypeError),
        (value.to(torch.complex128), idx, TypeError),
        (value[0], idx, ValueError),
        (value, idx[:1], ValueError),
        (value.t().contiguous().t(), idx, ValueError),
        (value.to("meta"), idx.to("meta"), ValueError),
    ]
    for v, i, err in bad:
        with pytest.raises(err):
            gather_sorted_cuda.gather_sorted(v, i)


def test_resample_particles_routes():
    rng = np.random.default_rng(3)
    value = {"s": _t(rng.integers(-9, 9, size=(2, 50)).astype(np.int32)),
             "x": _t(rng.normal(size=(2, 50, 2)).astype(np.float32))}
    idx = _t(_sorted_indices(rng, 2, 50, 50)).long()
    got = resampling.resample_particles(value, idx)
    for key, leaf in value.items():
        want = torch.take_along_dim(
            leaf, idx.reshape(idx.shape + (1,) * (leaf.ndim - 2)), dim=1)
        assert torch.equal(got[key], want)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        resampling.resample_particles(value, idx, implementation="cuda")


def test_non_float32_leaf_with_gradient_raises_on_the_cuda_route():
    logw = torch.zeros(2, 8)
    value = {"x": torch.zeros(2, 8), "w": torch.zeros(2, 8,
                                                     dtype=torch.float64,
                                                     requires_grad=True)}
    noise = ReplayNoise(uniforms=[np.full((2, 1), 0.5, np.float32)])
    with pytest.raises(ValueError, match="forward-only"):
        resampling._resample(logw, noise, value, "systematic", "cuda", True)
    # The plain route carries it.
    idx, out = resampling._resample(logw, ReplayNoise(uniforms=[
        np.full((2, 1), 0.5, np.float32)]), value, "systematic", "torch",
        False)
    assert idx is None and out["w"].requires_grad
    assert out["w"].dtype == torch.float64 and out["x"].dtype == torch.float32


@pytest.mark.parametrize("method", ["systematic", "stratified",
                                    "multinomial"])
def test_mixed_dict_matches_jax_pallas_route(method, monkeypatch):
    """The pattern of tests/test_hmm.py:304-332: int32 and float32 leaves
    through `sample_ancestral_index_and_resample`, against the JAX
    package's Pallas route under FORCE_INTERPRET; bit-equal, negative
    integers and integers above 2^24 included."""
    rng = np.random.default_rng(11)
    batch, k = 3, 600
    logw = (rng.normal(size=(batch, k)) * 2).astype(np.float32)
    ints = rng.integers(-2 ** 31, 2 ** 31, size=(batch, k)).astype(np.int32)
    ints[0, :4] = [-1, 2 ** 24 + 1, -(2 ** 30) - 3, 2 ** 31 - 1]
    value = {"disc": ints,
             "x": rng.normal(size=(batch, k, 2)).astype(np.float32)}
    key = jax.random.PRNGKey(4)
    monkeypatch.setattr(resample_pallas, "FORCE_INTERPRET", True)
    want_idx, want = jax_resampling.sample_ancestral_index_and_resample(
        jnp.asarray(logw), key, {n: jnp.asarray(v) for n, v in value.items()},
        method=method, implementation="pallas")
    monkeypatch.setattr(resampling, "_normalized_cumsum", _jax_cdf)
    for need_indices in (True, False):
        noise = ReplayNoise(**_resampling_noise(key, batch, k, method))
        idx, got = resampling.sample_ancestral_index_and_resample(
            _t(logw), noise, {n: _t(v) for n, v in value.items()},
            method=method, need_indices=need_indices)
        assert noise.exhausted()
        if need_indices:
            np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
        else:
            assert idx is None
        assert got["disc"].dtype == torch.int32
        for name in value:
            np.testing.assert_array_equal(got[name].numpy(),
                                          np.asarray(want[name]), name)


def _resampling_noise(key, batch, k, method):
    if method == "multinomial":
        return {"exponentials": [jax.random.exponential(
            key, (batch, k + 1), dtype=jnp.float32)]}
    shape = (batch, 1) if method == "systematic" else (batch, k)
    return {"uniforms": [jax.random.uniform(key, shape, dtype=jnp.float32)]}


@pytest.mark.parametrize("row_bytes,addresses,unit", [
    (4, (0, 256), 4),           # D = 1 int32: one 4-byte element a row
    (1, (0, 256), 1),           # D = 1 int8
    (32, (0, 256), 16),         # D = 8 int32: two 16-byte elements
    (256, (512, 1024), 16),     # D = 64 int32
    (24, (0, 256), 8),          # D = 3 float64, or 6 int32
    (12, (0, 256), 4),          # D = 3 int32
    (3, (0, 256), 1),           # D = 3 int8
    (32, (4, 256), 4),          # a value at an address 4 bytes off 16
    (32, (0, 258), 2),          # an output 2 bytes off 16
])
def test_unit_is_the_widest_aligned_element(row_bytes, addresses, unit):
    assert gather_sorted_cuda._unit(row_bytes, *addresses) == unit


@pytest.mark.parametrize("dtype,trailing,columns,unit", [
    (torch.int32, (), 1, 4),
    (torch.int8, (), 1, 1),
    (torch.int32, (8,), 2, 16),
    (torch.float64, (2, 2), 2, 16),
    (torch.bool, (3,), 3, 1),
    (torch.int16, (2,), 1, 4),
])
def test_launch_passes_rows_as_wide_elements(dtype, trailing, columns, unit,
                                             monkeypatch):
    """What the wrapper hands the C entry: each row of D elements as
    row bytes / unit elements of `unit` bytes (the kernel's template), on
    CPU tensors with the launch stubbed."""
    calls = []

    def entry(*args):
        calls.append(args)
        return 0

    monkeypatch.setattr(gather_sorted_cuda._launch, "entry",
                        lambda *a: entry)
    monkeypatch.setattr(gather_sorted_cuda._launch, "target",
                        lambda t: (0, 0))
    value = torch.zeros((3, 5) + trailing, dtype=dtype)
    idx = torch.zeros((3, 7), dtype=torch.int32)
    before = gather_sorted_cuda.LAUNCHES
    out = gather_sorted_cuda._launch_kernel(value, idx)
    assert out.shape == (3, 7) + trailing and out.dtype == dtype
    assert gather_sorted_cuda.LAUNCHES == before + 1
    (args,) = calls
    assert args[3:9] == (3, 5, 7, columns, unit, 0)
