"""The port's range sum (K2), the backward of the fused resample+gather
kernels, against the JAX package.

On the CPU the port's wrapper runs its plain PyTorch version; the JAX side
runs `gather_backward_pallas` (the Pallas range-sum kernel) through the
interpreter. Both get the JAX package's CDF and positions and integer
cotangents in [-5, 5], so every sum is exact in float32 and the results
must be equal, whatever order each side adds in.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aesmc_tpu import resampling as jax_resampling
from aesmc_tpu.ops import resample_pallas
from aesmc_tpu_torch.ops import range_sum_cuda, resample_cuda
import torch_threads  # noqa: F401  (caps PyTorch's threads)


def _t(x):
    return torch.tensor(np.asarray(x))


# The particle that holds all the mass of a row, by kind of problem.
HOT = {"one_particle": None, "first_particle": 0, "last_particle": -1}


def _problem(seed, batch, k, scale, kind=None):
    """Log-weights with zero-weight runs (empty segments), or with all
    mass on one particle a row (a random one, the first or the last)."""
    rng = np.random.default_rng(seed)
    logw = (rng.normal(size=(batch, k)) * scale).astype(np.float32)
    if kind in HOT:
        hot = HOT[kind]
        logw = np.full((batch, k), -np.inf, np.float32)
        logw[np.arange(batch),
             rng.integers(0, k, size=batch) if hot is None else hot] = 0.0
    elif k > 2:
        logw[:, :: (seed % 5) + 3] = -np.inf
    return logw


def _cotangents(seed, batch, kp, d):
    rng = np.random.default_rng(seed + 1)
    return rng.integers(-5, 6, size=(batch, kp, d)).astype(np.float32)


def _jax_range_sum(cdf, pos, g):
    cols = [jnp.asarray(g[:, :, c]) for c in range(g.shape[2])]
    grads = resample_pallas.gather_backward_pallas(
        jnp.asarray(cdf), jnp.asarray(pos), cols, interpret=True)
    return np.stack([np.asarray(x) for x in grads], axis=-1)


CASES = [
    # (seed, batch, k, kp, d, scale, method, kind)
    (0, 3, 1024, 1024, 1, 1.0, "systematic", None),
    (1, 2, 640, 640, 2, 25.0, "systematic", None),    # heavy degeneracy
    (2, 2, 1536, 1536, 1, 3.0, "stratified", None),
    (3, 1, 2048, 2048, 1, 40.0, "multinomial", None),  # near point mass
    (4, 2, 1000, 1000, 3, 1.0, "systematic", "one_particle"),
    (5, 2, 1, 1, 1, 1.0, "systematic", None),          # K = 1
    (6, 2, 2048, 512, 1, 2.0, "systematic", None),     # Kp < K
    (7, 2, 512, 2048, 2, 2.0, "stratified", None),     # Kp > K
    # One segment over every slot tile of the kernel (1,024 slots each),
    # with the empty sources after it, or before it.
    (8, 2, 4096, 4096, 1, 1.0, "systematic", "first_particle"),
    (9, 2, 4096, 4096, 2, 1.0, "stratified", "last_particle"),
    (10, 1, 1000, 3 * 1024 + 17, 3, 2.0, "multinomial", None),  # ragged tile
]


@pytest.mark.parametrize("seed,batch,k,kp,d,scale,method,kind", CASES)
def test_plain_range_sum_matches_pallas_exactly(seed, batch, k, kp, d, scale,
                                                method, kind):
    logw = _problem(seed, batch, k, scale, kind)
    cdf = np.asarray(jax_resampling._normalized_cumsum(jnp.asarray(logw)))
    pos = np.asarray(jax_resampling.resampling_positions(
        jnp.zeros((batch, kp), jnp.float32), jax.random.PRNGKey(seed),
        method))
    g = _cotangents(seed, batch, kp, d)
    want = _jax_range_sum(cdf, pos, g)
    got = range_sum_cuda.range_sum(_t(cdf), _t(pos), _t(g))
    assert got.shape == (batch, k, d) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    # Every cotangent lands on exactly one source.
    np.testing.assert_array_equal(got.numpy().sum(axis=1), g.sum(axis=1))
    if kind in HOT:
        hot = np.argmax(logw, axis=1)
        np.testing.assert_array_equal(
            got.numpy()[np.arange(batch), hot], g.sum(axis=1))


@pytest.mark.parametrize("d", [1, 3])
@pytest.mark.parametrize("k", [1, 7, 1000])
def test_systematic_autograd_matches_take_along_dim(k, d):
    """K1's gradient on CPU tensors (forward and backward plain versions,
    through the autograd wrapper) equals autograd through the plain
    gather, and the index output carries no gradient."""
    rng = np.random.default_rng(k + d)
    logw = _t((rng.normal(size=(2, k)) * 2).astype(np.float32))
    cdf = _t(jax_resampling._normalized_cumsum(jnp.asarray(logw.numpy())))
    u = _t(rng.uniform(size=(2, 1)).astype(np.float32))
    g = _t(rng.normal(size=(2, k, d)).astype(np.float32))
    value = _t(rng.normal(size=(2, k, d)).astype(np.float32))

    v1 = value.clone().requires_grad_()
    idx, out = resample_cuda.resample_and_gather_systematic(cdf, u, v1)
    (out * g).sum().backward()
    v2 = value.clone().requires_grad_()
    _, want = resample_cuda.resample_and_gather_systematic_torch(cdf, u, v2)
    (want * g).sum().backward()
    assert torch.equal(out, want)
    assert not idx.requires_grad and idx.grad_fn is None
    np.testing.assert_allclose(v1.grad.numpy(), v2.grad.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_systematic_backward_positions_are_the_forward_grid(monkeypatch):
    """The backward rebuilds the forward's positions bit for bit: with
    integer cotangents the value gradient equals the JAX systematic VJP
    (`resample_and_gather_systematic`, interpreted) exactly."""
    rng = np.random.default_rng(11)
    batch, k = 2, 1025
    logw = (rng.normal(size=(batch, k)) * 4).astype(np.float32)
    logw[:, ::6] = -np.inf
    u = rng.uniform(size=(batch, 1)).astype(np.float32)
    value = rng.normal(size=(batch, k)).astype(np.float32)
    g = rng.integers(-5, 6, size=(batch, k)).astype(np.float32)

    monkeypatch.setattr(resample_pallas, "FORCE_INTERPRET", True)

    def f(v):
        _, (out,) = resample_pallas.resample_and_gather_systematic(
            False, jnp.asarray(logw), jnp.asarray(u), (v,))
        return jnp.sum(out * jnp.asarray(g))

    want = np.asarray(jax.grad(f)(jnp.asarray(value)))

    cdf = _t(jax_resampling._normalized_cumsum(jnp.asarray(logw)))
    v = _t(value)[:, :, None].requires_grad_()
    _, out = resample_cuda.resample_and_gather_systematic(
        cdf, _t(u), v, emit_idx=False)
    (out[:, :, 0] * _t(g)).sum().backward()
    np.testing.assert_array_equal(v.grad[:, :, 0].numpy(), want)


def test_wrapper_checks_inputs_and_counts_no_cpu_launch():
    cdf = torch.linspace(0.1, 1.0, 10).repeat(2, 1)
    pos = torch.linspace(0.0, 0.95, 12).repeat(2, 1)
    g = torch.ones(2, 12, 1)
    before = range_sum_cuda.LAUNCHES
    out = range_sum_cuda.range_sum(cdf, pos, g)
    assert range_sum_cuda.LAUNCHES == before
    assert float(out.sum()) == 24.0
    bad = [
        (cdf.double(), pos, g, TypeError),
        (cdf, pos, g.double(), TypeError),
        (cdf, pos, g[:, :, 0], ValueError),
        (cdf, pos, torch.ones(2, 11, 1), ValueError),
        (cdf, pos[:1], g[:1], ValueError),
        (cdf.t().contiguous().t(), pos, g, ValueError),
        (cdf.to("meta"), pos.to("meta"), g.to("meta"), ValueError),
    ]
    for c, p, gg, err in bad:
        with pytest.raises(err):
            range_sum_cuda.range_sum(c, p, gg)
