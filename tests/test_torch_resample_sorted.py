"""The port's search + gather over loaded sorted positions (K3), and the
stratified and multinomial resampling it carries, against the JAX package.

On the CPU the port's wrapper runs its plain PyTorch version; the JAX side
runs `sorted_search_gather_pallas` through the Pallas interpreter. Both
get the same CDF and positions, so indices and gathered values must agree
exactly. Stratified positions are bit-equal to JAX's on replayed uniforms;
multinomial positions are a cumulative sum, which torch and XLA add in
different orders, so they agree to a few ulps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aesmc_tpu import inference as jax_inference
from aesmc_tpu import resampling as jax_resampling
from aesmc_tpu.models import lgssm as jax_lgssm
from aesmc_tpu.ops import resample_pallas
from aesmc_tpu_torch import inference, resampling
from aesmc_tpu_torch.models import lgssm
from aesmc_tpu_torch.ops import _launch, resample_sorted_cuda
from torch_replay import (ReplayNoise, lgssm_params, replayed_noise,
                          simulate, tensor as _t)


def _problem(seed, batch, k, d, kind=None):
    rng = np.random.default_rng(seed)
    logw = (rng.normal(size=(batch, k)) * 3.0).astype(np.float32)
    if kind == "one_particle":
        logw = np.full((batch, k), -np.inf, np.float32)
        logw[np.arange(batch), rng.integers(0, k, size=batch)] = 0.0
    elif kind == "neg_inf":
        logw[:, : k // 4] = -np.inf
        logw[:, k // 2: k // 2 + k // 8] = -np.inf
        logw[:, -3:] = -np.inf
    value = rng.normal(size=(batch, k, d)).astype(np.float32)
    return logw, value


def _jax_positions(batch, kp, method, seed):
    return np.asarray(jax_resampling.resampling_positions(
        jnp.zeros((batch, kp), jnp.float32), jax.random.PRNGKey(seed),
        method))


def _jax_kernel(cdf, pos, value, emit_idx):
    cols = tuple(jnp.asarray(value[:, :, c]) for c in range(value.shape[2]))
    idx, gathered = resample_pallas.sorted_search_gather_pallas(
        jnp.asarray(cdf), jnp.asarray(pos), cols, emit_idx=emit_idx,
        interpret=True)
    out = np.stack([np.asarray(g) for g in gathered], axis=-1)
    return (None if idx is None else np.asarray(idx)), out


CASES = [
    # (seed, batch, k, kp, d, method, kind)
    (0, 2, 1000, 1000, 1, "stratified", None),
    (1, 2, 1025, 1025, 3, "multinomial", None),
    (2, 3, 1000, 1000, 2, "stratified", "neg_inf"),
    (3, 3, 1000, 1000, 2, "multinomial", "one_particle"),
    (4, 2, 1, 1, 1, "stratified", None),
    (5, 2, 2048, 512, 1, "systematic", None),     # Kp < K
    (6, 2, 512, 2048, 2, "multinomial", None),    # Kp > K
    (7, 2, 2049, 1025, 3, "stratified", None),   # Kp one past two tiles
]


@pytest.mark.parametrize("emit_idx", [True, False])
@pytest.mark.parametrize("seed,batch,k,kp,d,method,kind", CASES)
def test_plain_kernel_matches_pallas_exactly(seed, batch, k, kp, d, method,
                                             kind, emit_idx):
    logw, value = _problem(seed, batch, k, d, kind)
    cdf = np.asarray(jax_resampling._normalized_cumsum(jnp.asarray(logw)))
    pos = _jax_positions(batch, kp, method, seed)
    want_idx, want = _jax_kernel(cdf, pos, value, emit_idx)
    idx, got = resample_sorted_cuda.resample_and_gather_sorted(
        _t(cdf), _t(pos), _t(value), emit_idx=emit_idx)
    if emit_idx:
        assert idx.dtype == torch.int32 and idx.shape == (batch, kp)
        np.testing.assert_array_equal(idx.numpy(), want_idx)
    else:
        assert idx is None and want_idx is None
    assert got.shape == (batch, kp, d)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("method", ["stratified", "multinomial"])
@pytest.mark.parametrize("k", [1, 7, 1025, 10000])
def test_positions_match_jax(k, method):
    batch = 2
    key = jax.random.PRNGKey(k + 3)
    want = _jax_positions(batch, k, method, k + 3)
    if method == "stratified":
        noise = ReplayNoise(uniforms=[jax.random.uniform(
            key, (batch, k), dtype=jnp.float32)])
    else:
        noise = ReplayNoise(exponentials=[jax.random.exponential(
            key, (batch, k + 1), dtype=jnp.float32)])
    got = resampling.resampling_positions(torch.zeros(batch, k), noise,
                                          method).numpy()
    if method == "stratified":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert (np.diff(got, axis=1) >= 0).all() and got.max() < 1.0


@pytest.mark.parametrize("method", ["stratified", "multinomial"])
def test_indices_match_jax(method):
    logw, _ = _problem(8, 3, 1000, 1)
    key = jax.random.PRNGKey(9)
    fn = {"stratified": jax_resampling.stratified_indices,
          "multinomial": jax_resampling.multinomial_indices}[method]
    want = np.asarray(fn(jnp.asarray(logw), key))
    if method == "stratified":
        noise = ReplayNoise(uniforms=[jax.random.uniform(
            key, (3, 1000), dtype=jnp.float32)])
        got = resampling.stratified_indices(_t(logw), noise)
    else:
        noise = ReplayNoise(exponentials=[jax.random.exponential(
            key, (3, 1001), dtype=jnp.float32)])
        got = resampling.multinomial_indices(_t(logw), noise)
    assert got.dtype == torch.int32
    # torch and XLA sum the CDF (and the multinomial spacings) in
    # different orders: a position within ulps of a bin edge may pick the
    # neighbouring ancestor.
    assert (got.numpy() == want).mean() >= 0.999


@pytest.mark.parametrize("kp", [7, 300])
def test_sorted_autograd_matches_take_along_dim(kp):
    """K3's gradient on CPU tensors (plain forward, K2's plain backward)
    equals autograd through the plain gather; indices carry none."""
    logw, value = _problem(10, 2, 300, 2)
    cdf = _t(jax_resampling._normalized_cumsum(jnp.asarray(logw)))
    pos = _t(_jax_positions(2, kp, "stratified", 11))
    g = torch.randn(2, kp, 2, generator=torch.Generator().manual_seed(0))
    v1 = _t(value).requires_grad_()
    idx, out = resample_sorted_cuda.resample_and_gather_sorted(cdf, pos, v1)
    (out * g).sum().backward()
    v2 = _t(value).requires_grad_()
    _, want = resample_sorted_cuda.resample_and_gather_sorted_torch(
        cdf, pos, v2)
    (want * g).sum().backward()
    assert torch.equal(out, want) and not idx.requires_grad
    np.testing.assert_allclose(v1.grad.numpy(), v2.grad.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_wrapper_checks_inputs_and_counts_no_cpu_launch(monkeypatch):
    cdf = torch.linspace(0.1, 1.0, 10).repeat(2, 1)
    pos = torch.linspace(0.0, 0.95, 12).repeat(2, 1)
    value = torch.randn(2, 10, 1)
    before = resample_sorted_cuda.LAUNCHES
    idx, out = resample_sorted_cuda.resample_and_gather_sorted(cdf, pos,
                                                               value)
    assert resample_sorted_cuda.LAUNCHES == before
    assert idx.shape == (2, 12) and out.shape == (2, 12, 1)
    bad = [
        (cdf.double(), pos, value, TypeError),
        (cdf, pos.double(), value, TypeError),
        (cdf, pos, value[:, :, 0], ValueError),
        (cdf, pos, torch.randn(2, 9, 1), ValueError),
        (cdf, pos[:1], value, ValueError),
        (cdf, pos.t().contiguous().t(), value, ValueError),
        (cdf.to("meta"), pos.to("meta"), value.to("meta"), ValueError),
    ]
    for c, p, v, err in bad:
        with pytest.raises(err):
            resample_sorted_cuda.resample_and_gather_sorted(c, p, v)
    # The kernel indexes a tile's output run in 32 bits, so D is capped.
    monkeypatch.setattr(_launch, "MAX_COLUMNS", 2)
    resample_sorted_cuda.resample_and_gather_sorted(cdf, pos,
                                                    torch.randn(2, 10, 2))
    with pytest.raises(ValueError, match="D must be at most 2"):
        resample_sorted_cuda.resample_and_gather_sorted(cdf, pos,
                                                        torch.randn(2, 10, 3))


@pytest.mark.parametrize("method", ["stratified", "multinomial"])
def test_smc_matches_jax(method, monkeypatch):
    """Stratified and multinomial SMC on the LGSSM against JAX `infer`
    (its Pallas route, interpreted), on replayed uniforms and
    exponentials."""
    num_timesteps, batch, k = 8, 3, 400
    jax_comps = (jax_lgssm.Initial(0.0, 1.0),
                 jax_lgssm.Transition.create(0.9, 1.0),
                 jax_lgssm.Emission.create(1.0, 0.5),
                 jax_lgssm.Proposal.create(1.0, 0.8, jax.random.PRNGKey(1)))
    comps = lgssm.from_numpy(lgssm_params(jax_comps), device="cpu")
    obs = simulate(5, num_timesteps, batch)
    key = jax.random.PRNGKey(6)
    monkeypatch.setattr(resample_pallas, "FORCE_INTERPRET", True)
    want = jax_inference.infer(
        "smc", jnp.asarray(obs), *jax_comps, k, key=key,
        resampling_method=method, resampling_implementation="pallas",
        return_log_marginal_likelihood=True, return_original_latents=True,
        return_ancestral_indices=True)
    noise = replayed_noise(jax_comps[3], obs, key, want["original_latents"],
                           want["ancestral_indices"], method)
    with torch.no_grad():
        got = inference.infer(
            "smc", _t(obs), *comps, k, noise=noise,
            resampling_method=method, return_log_marginal_likelihood=True,
            return_ancestral_indices=True)
    assert noise.exhausted()
    np.testing.assert_allclose(got["log_marginal_likelihood"].numpy(),
                               np.asarray(want["log_marginal_likelihood"]),
                               rtol=0, atol=1e-3)
    same = (got["ancestral_indices"].numpy() ==
            np.asarray(want["ancestral_indices"]))
    assert same.mean() >= 0.999, same.mean()
    assert (np.diff(got["ancestral_indices"].numpy(), axis=2) >= 0).all()
