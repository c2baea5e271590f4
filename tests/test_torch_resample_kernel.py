"""The port's fused systematic resample+gather (K1) against the JAX package.

On the CPU the port's wrapper runs its plain PyTorch version; the JAX side
runs its Pallas kernel through the interpreter. Both get the same CDF and
the same uniforms, so ancestors and gathered values must agree exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aesmc_tpu import resampling as jax_resampling
from aesmc_tpu.ops import resample_pallas
from aesmc_tpu_torch import resampling
from aesmc_tpu_torch.ops import _build, _launch, resample_cuda
import torch_threads  # noqa: F401  (caps PyTorch's threads)


def _t(x):
    """A tensor holding a copy of ``x`` (JAX hands out read-only arrays)."""
    return torch.tensor(np.asarray(x))


class ReplayUniforms:
    """A noise source that hands out given resampling uniforms."""

    def __init__(self, u):
        self.u = _t(np.asarray(u, dtype=np.float32))

    def uniform(self, shape):
        assert tuple(shape) == tuple(self.u.shape)
        return self.u.clone()


def _inputs(batch, k, d, seed, degenerate=None):
    rng = np.random.RandomState(seed)
    logw = (rng.randn(batch, k) * 3.0).astype(np.float32)
    if degenerate == "one_particle":
        # All mass on one particle per row.
        logw = np.full((batch, k), -np.inf, np.float32)
        logw[np.arange(batch), rng.randint(0, k, size=batch)] = 0.0
    elif degenerate == "neg_inf":
        # Whole runs of zero weight, at the ends and inside the row.
        logw[:, : k // 4] = -np.inf
        logw[:, k // 2: k // 2 + k // 8] = -np.inf
        logw[:, -3:] = -np.inf
    value = rng.randn(batch, k, d).astype(np.float32)
    u = rng.uniform(size=(batch, 1)).astype(np.float32)
    return logw, value, u


def _jax_kernel(cdf, u, value, emit_idx):
    k = cdf.shape[1]
    cols = tuple(jnp.asarray(value[:, :, c]) for c in range(value.shape[2]))
    idx, gathered = resample_pallas.systematic_search_gather_pallas(
        jnp.asarray(cdf), jnp.asarray(u), k, cols, emit_idx=emit_idx,
        interpret=True)
    out = np.stack([np.asarray(g) for g in gathered], axis=-1)
    return (None if idx is None else np.asarray(idx)), out


# K = 1,024, 1,025 and 2,049 sit at the edges of the kernel's tiles of 512
# slots (two whole tiles, one slot past two, one slot past four).
CASES = [(2, k, d) for k in (1, 7, 1000, 1024, 1025, 2049) for d in (1, 3)]


@pytest.mark.parametrize("emit_idx", [True, False])
@pytest.mark.parametrize("batch,k,d", CASES)
def test_plain_kernel_matches_pallas_exactly(batch, k, d, emit_idx):
    logw, value, u = _inputs(batch, k, d, seed=k * 10 + d)
    # The JAX CDF feeds both sides: torch and XLA sum in different orders.
    cdf = np.asarray(jax_resampling._normalized_cumsum(jnp.asarray(logw)))
    want_idx, want = _jax_kernel(cdf, u, value, emit_idx)
    idx, got = resample_cuda.resample_and_gather_systematic(
        _t(cdf), _t(u), _t(value), emit_idx=emit_idx)
    if emit_idx:
        assert idx.dtype == torch.int32
        np.testing.assert_array_equal(idx.numpy(), want_idx)
    else:
        assert idx is None and want_idx is None
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("emit_idx", [True, False])
@pytest.mark.parametrize("degenerate", ["one_particle", "neg_inf"])
def test_degenerate_weights_match_pallas_exactly(degenerate, emit_idx):
    logw, value, u = _inputs(3, 1000, 2, seed=7, degenerate=degenerate)
    cdf = np.asarray(jax_resampling._normalized_cumsum(jnp.asarray(logw)))
    want_idx, want = _jax_kernel(cdf, u, value, emit_idx)
    idx, got = resample_cuda.resample_and_gather_systematic(
        _t(cdf), _t(u), _t(value), emit_idx=emit_idx)
    if emit_idx:
        np.testing.assert_array_equal(idx.numpy(), want_idx)
        if degenerate == "one_particle":
            assert (idx.numpy() == np.argmax(logw, axis=1)[:, None]).all()
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("degenerate", [None, "neg_inf"])
@pytest.mark.parametrize("k", [1, 7, 1000, 10000])
def test_normalized_cumsum_matches_jax(k, degenerate):
    logw, _, _ = _inputs(4, k, 1, seed=k, degenerate=degenerate)
    want = np.asarray(jax_resampling._normalized_cumsum(jnp.asarray(logw)))
    got = resampling._normalized_cumsum(_t(logw)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert (got[:, -1] == 1.0).all()
    assert (np.diff(got, axis=1) >= 0).all()


@pytest.mark.parametrize("k", [1, 7, 1025, 10000, 8388608])
def test_positions_bit_equal_to_jax(k):
    batch = 2 if k < 100000 else 1
    key = jax.random.PRNGKey(k)
    logw = jnp.zeros((batch, k), jnp.float32)
    want = np.asarray(jax_resampling.resampling_positions(
        logw, key, "systematic"))
    u = jax.random.uniform(key, (batch, 1), dtype=jnp.float32)
    got = resampling.resampling_positions(
        torch.zeros(batch, k), ReplayUniforms(u), "systematic").numpy()
    np.testing.assert_array_equal(got, want)
    assert got.max() < 1.0


def test_indices_match_jax_systematic():
    logw, _, _ = _inputs(3, 1000, 1, seed=3)
    key = jax.random.PRNGKey(5)
    want = np.asarray(jax_resampling.systematic_indices(
        jnp.asarray(logw), key))
    u = jax.random.uniform(key, (3, 1), dtype=jnp.float32)
    got = resampling.sample_ancestral_index(_t(logw),
                                            ReplayUniforms(u))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_resample_keeps_dict_values():
    logw, value, u = _inputs(2, 300, 3, seed=11)
    value = {"x": _t(value[:, :, 0]),
             "y": _t(value[:, :, 1:])}
    idx, out = resampling.sample_ancestral_index_and_resample(
        _t(logw), ReplayUniforms(u), value)
    assert idx.shape == (2, 300)
    for key in value:
        want = torch.take_along_dim(
            value[key], idx.long().reshape(idx.shape + (1,) *
                                           (value[key].ndim - 2)), dim=1)
        assert torch.equal(out[key], want)
    idx2, _ = resampling.sample_ancestral_index_and_resample(
        _t(logw), ReplayUniforms(u), value, need_indices=False)
    assert idx2 is None


def test_cuda_implementation_on_cpu_tensors_raises():
    logw = torch.zeros(2, 16)
    value = torch.zeros(2, 16)
    src = ReplayUniforms(np.full((2, 1), 0.5))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        resampling.sample_ancestral_index_and_resample(
            logw, src, value, implementation="cuda")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        resampling.resolve_implementation(torch.device("cpu"), "systematic",
                                          "cuda")
    assert resampling.resolve_implementation(
        torch.device("cpu"), "systematic", "auto") == "torch"
    assert resampling.resolve_implementation(
        torch.device("cuda", 0), "systematic", "auto") == "cuda"
    with pytest.raises(ValueError, match="method"):
        resampling.resolve_implementation(torch.device("cpu"), "bogus",
                                          "auto")
    # Residual resampling has no kernel: 'auto' is 'torch' on every device.
    for device in ("cpu", "cuda"):
        assert resampling.resolve_implementation(
            torch.device(device), "residual", "auto") == "torch"
    with pytest.raises(ValueError, match="no fused kernel"):
        resampling.resolve_implementation(torch.device("cuda", 0),
                                          "residual", "cuda")


def test_nan_log_weight_raises_at_public_entry():
    logw = torch.zeros(2, 8)
    logw[1, 3] = float("nan")
    src = ReplayUniforms(np.full((2, 1), 0.5))
    with pytest.raises(FloatingPointError):
        resampling.sample_ancestral_index_and_resample(logw, src,
                                                       torch.zeros(2, 8))
    with pytest.raises(FloatingPointError):
        resampling.sample_ancestral_index(logw, src)


def test_wrapper_checks_inputs_and_counts_no_cpu_launch(monkeypatch):
    cdf = torch.linspace(0.1, 1.0, 10).repeat(2, 1)
    u = torch.full((2, 1), 0.3)
    value = torch.randn(2, 10, 1)
    before = resample_cuda.LAUNCHES
    resample_cuda.resample_and_gather_systematic(cdf, u, value)
    assert resample_cuda.LAUNCHES == before
    bad = [
        (cdf.double(), u, value, TypeError),
        (cdf, u, value.double(), TypeError),
        (cdf, u, value[:, :, 0], ValueError),
        (cdf, u, torch.randn(2, 9, 1), ValueError),
        (cdf, torch.full((3, 1), 0.3), value, ValueError),
        (cdf.t().contiguous().t(), u, value, ValueError),
        (cdf.to("meta"), u.to("meta"), value.to("meta"), ValueError),
    ]
    for c, uu, v, err in bad:
        with pytest.raises(err):
            resample_cuda.resample_and_gather_systematic(c, uu, v)
    # The kernel indexes a tile's output run in 32 bits, so D is capped.
    monkeypatch.setattr(_launch, "MAX_COLUMNS", 2)
    resample_cuda.resample_and_gather_systematic(cdf, u, torch.randn(2, 10, 2))
    with pytest.raises(ValueError, match="D must be at most 2"):
        resample_cuda.resample_and_gather_systematic(cdf, u,
                                                     torch.randn(2, 10, 3))


def test_gradient_is_not_ported():
    """The gradient (K2's plain version on the CPU) reaches the values
    only: each source gets one for every slot that gathered it, and the
    indices carry none."""
    cdf = torch.linspace(0.1, 1.0, 10).repeat(2, 1)
    value = torch.randn(2, 10, 1, requires_grad=True)
    idx, out = resample_cuda.resample_and_gather_systematic(
        cdf, torch.full((2,), 0.3), value)
    assert not idx.requires_grad
    out.sum().backward()
    counts = torch.bincount(idx[0].long(), minlength=10).float()
    assert torch.equal(value.grad[0, :, 0], counts)


@pytest.mark.parametrize("header", ["sorted_search.cuh", "tile_gather.cuh"])
@pytest.mark.parametrize("source", ["resample_systematic.cu",
                                    "resample_sorted.cu"])
def test_library_is_rebuilt_when_a_header_changes(source, header, tmp_path,
                                                  monkeypatch):
    """K1 and K3 include both headers: a library named by the bytes of the
    source alone would survive a change to either."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for path in _build.CSRC.iterdir():
        (csrc / path.name).write_bytes(path.read_bytes())
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = _build.library_path(source)
    assert f'#include "{header}"' in (csrc / source).read_text()
    with open(csrc / header, "a") as f:
        f.write("// changed\n")
    after = _build.library_path(source)
    assert after != before and after.parent == before.parent
