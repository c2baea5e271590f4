"""Residual, dense and soft resampling in the port, against the JAX package.

The same log-weights (made from a numpy seed) go through both packages,
with the JAX draws replayed: the uniforms of residual resampling and the
exponentials of soft resampling's multinomial positions are redrawn from
the JAX key, and the JAX package's normalized CDF is patched into the
port where a search reads it, so that the ancestors compare exactly.

Tolerances: indices exactly equal; values passed through by the dense
route bit for bit (also under `set_float32_matmul_precision('medium')`);
soft resampling's corrected log-weights and every gradient within 1e-5
(absolute, on values of order 1: the two packages sum in other orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aesmc_tpu import resampling as jax_resampling
from aesmc_tpu_torch import resampling
from aesmc_tpu_torch.ops import range_sum_cuda, resample_sorted_cuda
from torch_replay import ReplayNoise, tensor as _t

TOL = 1e-5


def _log_weights(seed, batch, k, peaked=False):
    rng = np.random.RandomState(seed)
    logw = rng.randn(batch, k).astype(np.float32) * (4.0 if peaked else 1.0)
    return logw


@pytest.fixture
def jax_cdf(monkeypatch):
    """The port searches the JAX package's normalized CDF."""
    def cdf(log_weight):
        return _t(jax_resampling._normalized_cumsum(
            jnp.asarray(log_weight.detach().numpy())))

    monkeypatch.setattr(resampling, "_normalized_cumsum", cdf)


@pytest.mark.parametrize("batch,k,peaked", [(3, 40, False), (2, 300, True),
                                            (4, 7, True)])
def test_residual_indices_match_jax(batch, k, peaked):
    logw = _log_weights(1, batch, k, peaked)
    key = jax.random.PRNGKey(k)
    want = np.asarray(jax_resampling.residual_indices(jnp.asarray(logw),
                                                      key))
    u = jax.random.uniform(key, (batch, k), dtype=jnp.float32)
    got = resampling.sample_ancestral_index(
        _t(logw), ReplayNoise(uniforms=[u]), "residual")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # The gather of any dtype follows the indices, on every route.
    value = {"x": torch.randn(batch, k, 2),
             "s": torch.arange(batch * k, dtype=torch.int32).reshape(batch,
                                                                     k)}
    idx, out = resampling.sample_ancestral_index_and_resample(
        _t(logw), ReplayNoise(uniforms=[u]), value, "residual")
    np.testing.assert_array_equal(idx.numpy(), want)
    index = idx.long()
    assert torch.equal(out["x"], torch.take_along_dim(
        value["x"], index[..., None], dim=1))
    assert torch.equal(out["s"], torch.gather(value["s"], 1, index))


@pytest.mark.parametrize("precision", ["highest", "medium"])
def test_dense_route_matches_jax_bit_for_bit(precision, jax_cdf):
    batch, k = 3, 64
    logw = _log_weights(2, batch, k, peaked=True)
    key = jax.random.PRNGKey(3)
    pos = jax_resampling.resampling_positions(jnp.asarray(logw), key,
                                              "stratified")
    rng = np.random.RandomState(4)
    x = rng.randn(batch, k).astype(np.float32)
    y = (rng.randn(batch, k, 3) * 1e3 + 1e-3).astype(np.float32)
    g = rng.randn(batch, k).astype(np.float32)

    def jax_loss(values):
        _, out = jax_resampling.dense_indices_and_gather(
            jnp.asarray(logw), pos, values)
        return jnp.sum(out["x"] * g) + jnp.sum(out["y"] ** 2) * 1e-6, out

    (_, want), grads = jax.value_and_grad(jax_loss, has_aux=True)(
        {"x": jnp.asarray(x), "y": jnp.asarray(y)})
    want_idx, _ = jax_resampling.dense_indices_and_gather(
        jnp.asarray(logw), pos, {"x": jnp.asarray(x)})

    values = {"x": _t(x).requires_grad_(), "y": _t(y).requires_grad_()}
    previous = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision(precision)
    try:
        idx, out = resampling.dense_indices_and_gather(_t(logw), _t(pos),
                                                       values)
        loss = (out["x"] * _t(g)).sum() + (out["y"] ** 2).sum() * 1e-6
        loss.backward()
    finally:
        torch.set_float32_matmul_precision(previous)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    for name in ("x", "y"):
        np.testing.assert_array_equal(out[name].detach().numpy(),
                                      np.asarray(want[name]))
        np.testing.assert_allclose(values[name].grad.numpy(),
                                   np.asarray(grads[name]), rtol=TOL,
                                   atol=TOL)


def test_torch_route_takes_dense_up_to_its_k(monkeypatch):
    calls = []
    real = resampling.dense_indices_and_gather

    def spy(log_weight, pos, value):
        calls.append(log_weight.shape[1])
        return real(log_weight, pos, value)

    monkeypatch.setattr(resampling, "dense_indices_and_gather", spy)
    for k in (resampling.DENSE_GATHER_MAX_K, resampling.DENSE_GATHER_MAX_K
              + 1):
        logw = torch.randn(2, k)
        u = torch.rand(2, 1)
        want = resampling.sample_ancestral_index(
            logw, ReplayNoise(uniforms=[u]))
        value = torch.randn(2, k, 2)
        idx, out = resampling.sample_ancestral_index_and_resample(
            logw, ReplayNoise(uniforms=[u]), value)
        assert torch.equal(idx, want)
        assert torch.equal(out, torch.take_along_dim(
            value, idx.long()[..., None], dim=1))
    # Integer particles never take the dense route.
    resampling.sample_ancestral_index_and_resample(
        torch.randn(2, 8), ReplayNoise(uniforms=[torch.rand(2, 1)]),
        torch.zeros(2, 8, dtype=torch.int32))
    assert calls == [resampling.DENSE_GATHER_MAX_K]


def _jax_soft(logw, key, value, alpha, c):
    """The JAX package's soft resampling on its 'xla' route: indices,
    corrected log-weights, gathered value, and the gradients of
    sum(corrected * c) + sum(gathered) with respect to the log-weights
    and the value."""
    def loss(lw, v):
        idx, corrected, out = jax_resampling.soft_resample_and_gather(
            lw, key, v, alpha=alpha, implementation="xla")
        return jnp.sum(corrected * c) + jnp.sum(out), (idx, corrected, out)

    (_, aux), grads = jax.value_and_grad(loss, argnums=(0, 1),
                                         has_aux=True)(jnp.asarray(logw),
                                                       jnp.asarray(value))
    return aux, grads


def _port_soft(logw, draws, value, alpha, c, implementation):
    lw = _t(logw).requires_grad_()
    v = _t(value).requires_grad_()
    idx, corrected, out = resampling.soft_resample_and_gather(
        lw, ReplayNoise(exponentials=draws), v, alpha=alpha,
        implementation=implementation)
    ((corrected * _t(c)).sum() + out.sum()).backward()
    return idx, corrected.detach(), out.detach(), lw.grad, v.grad


@pytest.mark.parametrize("alpha", [0.5, 1.0])
def test_soft_resampling_matches_jax(alpha, jax_cdf, monkeypatch):
    batch, k = 3, 200
    logw = _log_weights(5, batch, k, peaked=True)
    key = jax.random.PRNGKey(6)
    value = np.random.RandomState(7).randn(batch, k).astype(np.float32)
    c = np.random.RandomState(8).randn(batch, k).astype(np.float32)
    (want_idx, want_corr, want_out), (want_glw, want_gv) = _jax_soft(
        logw, key, value, alpha, c)
    draws = [jax.random.exponential(key, (batch, k + 1), dtype=jnp.float32)]

    idx, corrected, out, glw, gv = _port_soft(logw, draws, value, alpha, c,
                                              "torch")
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_allclose(corrected.numpy(), np.asarray(want_corr),
                               rtol=0, atol=TOL)
    np.testing.assert_array_equal(out.numpy(), np.asarray(want_out))
    np.testing.assert_allclose(glw.numpy(), np.asarray(want_glw), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(gv.numpy(), np.asarray(want_gv), rtol=0,
                               atol=TOL)

    # The 'cuda' route (its wrappers' plain versions on CPU tensors): one
    # K3 launch over the value column and the two weight columns, and
    # K2 as its backward.
    launches, backward = [], []
    real_k3 = resample_sorted_cuda.resample_and_gather_sorted
    real_k2 = range_sum_cuda.range_sum

    def k3(cdf, pos, flat, emit_idx=True):
        launches.append(tuple(flat.shape))
        return real_k3(cdf, pos, flat, emit_idx)

    def k2(cdf, pos, g):
        backward.append(tuple(g.shape))
        return real_k2(cdf, pos, g)

    monkeypatch.setattr(resample_sorted_cuda, "resample_and_gather_sorted",
                        k3)
    monkeypatch.setattr(range_sum_cuda, "range_sum", k2)
    monkeypatch.setattr(
        resampling, "_route",
        lambda device, implementation: "torch" if implementation == "torch"
        else "cuda")
    kidx, kcorr, kout, kglw, kgv = _port_soft(logw, draws, value, alpha, c,
                                              "auto")
    assert launches == [(batch, k, 1 + 2)]
    assert backward == [(batch, k, 1 + 2)]
    assert torch.equal(kidx, idx) and torch.equal(kout, out)
    assert torch.equal(kcorr, corrected)
    np.testing.assert_allclose(kglw.numpy(), glw.numpy(), rtol=0, atol=TOL)
    np.testing.assert_allclose(kgv.numpy(), gv.numpy(), rtol=0, atol=TOL)


def test_soft_unfused_formula_matches_jax(jax_cdf):
    batch, k = 2, 50
    logw = _log_weights(9, batch, k)
    key = jax.random.PRNGKey(10)
    want_idx, want = jax_resampling.soft_indices_and_weights(
        jnp.asarray(logw), key, alpha=0.3)
    draws = [jax.random.exponential(key, (batch, k + 1), dtype=jnp.float32)]
    idx, got = resampling.soft_indices_and_weights(
        _t(logw), ReplayNoise(exponentials=draws), alpha=0.3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL)
