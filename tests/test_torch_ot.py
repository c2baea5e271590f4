"""The port's OT resampling (`aesmc_tpu_torch.ot`) and `infer`'s 'ot'
branch against the JAX package's, on the same numpy inputs.

Shapes of `tests/test_ot.py`: the dense form at (B, K, D) = (2, 32, 1) and
(3, 64, 2) and on a dict of particles; the blocked form at (2, 1,024, 3)
with blocks of 256, and the auto block at K = 4,106 (no divisor in [256,
2,048]: a warning and block 2), 4,609 (block 419) and 10,000 (block
2,000); the low-rank form at (2, 128, 2) with its jitter replayed from
the JAX key (`split(key)`: Q's normals, then R's). Gradients through all three.
`infer('smc', ..., resampling_method='ot')` on the LGSSM at (T, B, K) =
(6, 3, 32), dense and low-rank, with the proposal's normals from `split(key,
(T, 2))[t, 1]` and the low-rank jitter from `split([t, 0])`.

Tolerances: transported particles within 2e-5 absolute and gradients within
1e-4 (float32 logsumexp and matmul sums in another order, compounded over
the Sinkhorn iterations); `infer`'s log-Z within 1e-4 and its last
particles within 1e-4 (the same, over T steps).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aesmc_tpu import inference as jax_inference
from aesmc_tpu import ot as jax_ot
from aesmc_tpu.models import lgssm as jax_lgssm
from aesmc_tpu_torch import inference, losses, ot
from aesmc_tpu_torch.models import lgssm
from torch_replay import (ReplayNoise, lgssm_params, normal_draw, simulate,
                          tensor)

ATOL = 2e-5
GRAD_ATOL = 1e-4


def _inputs(b, k, d, seed):
    rng = np.random.RandomState(seed)
    shape = (b, k) if d is None else (b, k, d)
    return (rng.randn(b, k).astype(np.float32),
            rng.randn(*shape).astype(np.float32))


def _grads(fn, logw, x):
    """d sum(sin(fn(logw, x))) / d(logw, x), torch."""
    lw = torch.tensor(logw, requires_grad=True)
    xx = torch.tensor(x, requires_grad=True)
    out, _ = fn(lw, xx)
    torch.sin(out).sum().backward()
    return lw.grad.numpy(), xx.grad.numpy()


def _jax_grads(fn, logw, x):
    return [np.asarray(g) for g in jax.grad(
        lambda lw, xx: jnp.sum(jnp.sin(fn(lw, xx)[0])), argnums=(0, 1))(
            jnp.asarray(logw), jnp.asarray(x))]


@pytest.mark.parametrize("b,k,d,epsilon,iterations", [
    (2, 32, 1, 0.5, 200), (3, 64, None, 0.2, 200), (3, 64, 2, 0.5, 20)])
def test_dense_matches_jax(b, k, d, epsilon, iterations):
    logw, x = _inputs(b, k, d, seed=k)
    got, new_lw = ot.ot_resample(torch.tensor(logw), torch.tensor(x),
                                 epsilon=epsilon,
                                 num_iterations=iterations)
    want, _ = jax_ot.ot_resample(jnp.asarray(logw), jnp.asarray(x),
                                 epsilon=epsilon, num_iterations=iterations)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    assert torch.equal(new_lw, torch.zeros(b, k))
    for g, w in zip(
            _grads(lambda lw, xx: ot.ot_resample(
                lw, xx, epsilon=epsilon, num_iterations=iterations),
                logw, x),
            _jax_grads(lambda lw, xx: jax_ot.ot_resample(
                lw, xx, epsilon=epsilon, num_iterations=iterations),
                logw, x)):
        np.testing.assert_allclose(g, w, atol=GRAD_ATOL)


def test_sinkhorn_marginals_match_jax():
    """`tests/test_ot.py:28-30`: the plan's rows sum to the weights and its
    columns to 1/K, and the potentials equal the JAX package's."""
    logw, x = _inputs(2, 32, 1, seed=0)
    sq = (x * x).sum(-1)
    cost = sq[:, :, None] + sq[:, None, :] - 2 * np.einsum("bkd,bld->bkl",
                                                           x, x)
    f, g = ot.sinkhorn_potentials(torch.tensor(logw), torch.tensor(cost),
                                  0.5, 200)
    jf, jg = jax_ot.sinkhorn_potentials(jnp.asarray(logw),
                                        jnp.asarray(cost), 0.5, 200)
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), atol=1e-4)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=1e-4)
    plan = torch.exp((f[:, :, None] + g[:, None, :] - torch.tensor(cost)) /
                     0.5)
    np.testing.assert_allclose(plan.sum(2).numpy(),
                               torch.softmax(torch.tensor(logw), -1).numpy(),
                               atol=1e-3)
    np.testing.assert_allclose(plan.sum(1).numpy(), np.full((2, 32), 1 / 32),
                               atol=1e-3)


def test_dict_particles_match_jax():
    rng = np.random.RandomState(3)
    value = {"a": rng.randn(2, 16).astype(np.float32),
             "b": rng.randn(2, 16, 3).astype(np.float32)}
    logw = rng.randn(2, 16).astype(np.float32)
    got, _ = ot.ot_resample(torch.tensor(logw),
                            {k: torch.tensor(v) for k, v in value.items()})
    want, _ = jax_ot.ot_resample(jnp.asarray(logw),
                                 {k: jnp.asarray(v) for k, v in
                                  value.items()})
    for key in value:
        assert got[key].shape == value[key].shape
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=ATOL)


def test_blocked_matches_jax_and_dense():
    logw, x = _inputs(2, 1024, 3, seed=5)
    kwargs = dict(num_iterations=10, block_size=256)
    got, _ = ot.ot_resample(torch.tensor(logw), torch.tensor(x), **kwargs)
    want, _ = jax_ot.ot_resample(jnp.asarray(logw), jnp.asarray(x), **kwargs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    dense, _ = ot.ot_resample(torch.tensor(logw), torch.tensor(x),
                              num_iterations=10)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), atol=ATOL)
    logw, x = _inputs(1, 1024, 2, seed=6)
    for g, w in zip(
            _grads(lambda lw, xx: ot.ot_resample(lw, xx, **kwargs), logw, x),
            _jax_grads(lambda lw, xx: jax_ot.ot_resample(lw, xx, **kwargs),
                       logw, x)):
        np.testing.assert_allclose(g, w, atol=GRAD_ATOL)
    with pytest.raises(ValueError, match="multiple of block_size"):
        ot.ot_resample(torch.tensor(logw), torch.tensor(x[:, :1000]),
                       block_size=256)


@pytest.mark.parametrize("k,block,warns", [(4106, 2, True),
                                           (4609, 419, False),
                                           (10000, 2000, False)])
def test_auto_block(k, block, warns, monkeypatch):
    """Above `OT_DENSE_MAX_K` the blocked form takes the largest divisor of
    K up to 2,048, with the JAX package's warning below 256."""
    seen = []
    original = ot.ot_resample_blocked

    def spy(*args, **kwargs):
        seen.append(kwargs["block_size"])
        return original(*args, **kwargs)

    monkeypatch.setattr(ot, "ot_resample_blocked", spy)
    logw, x = _inputs(1, k, None, seed=7)
    if warns:
        with pytest.warns(RuntimeWarning, match="auto block_size"):
            out, _ = ot.ot_resample(torch.tensor(logw), torch.tensor(x),
                                    num_iterations=1)
    else:
        out, _ = ot.ot_resample(torch.tensor(logw), torch.tensor(x),
                                num_iterations=1)
    assert seen == [block] and bool(torch.isfinite(out).all())
    want, _ = jax_ot.ot_resample(jnp.asarray(logw), jnp.asarray(x),
                                 num_iterations=1)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=ATOL)


def _lowrank_noise(key, b, k, rank):
    k1, k2 = jax.random.split(key)
    return ReplayNoise(normals=[np.asarray(jax.random.normal(kk, (b, k, rank)))
                                for kk in (k1, k2)])


def test_lowrank_matches_jax():
    logw, x = _inputs(2, 128, 2, seed=0)
    key = jax.random.PRNGKey(4)
    kwargs = dict(rank=16, num_iterations=20)
    noise = _lowrank_noise(key, 2, 128, 16)
    got, new_lw = ot.lowrank_ot_resample(torch.tensor(logw), torch.tensor(x),
                                         noise=noise, **kwargs)
    assert noise.exhausted()
    want, _ = jax_ot.lowrank_ot_resample(jnp.asarray(logw), jnp.asarray(x),
                                         key=key, **kwargs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    assert torch.equal(new_lw, torch.zeros(2, 128))
    logw, x = _inputs(2, 64, 2, seed=1)
    for g, w in zip(
            _grads(lambda lw, xx: ot.lowrank_ot_resample(
                lw, xx, noise=_lowrank_noise(key, 2, 64, 16), **kwargs),
                logw, x),
            _jax_grads(lambda lw, xx: jax_ot.lowrank_ot_resample(
                lw, xx, key=key, **kwargs), logw, x)):
        np.testing.assert_allclose(g, w, atol=GRAD_ATOL)


def test_distributed_form_not_ported(monkeypatch):
    """The distributed form (ported now; the name is the earlier slice's):
    on a group of one rank the ring-streamed Sinkhorn is the blocked one
    with a single block, and its gradients are the blocked form's. Its
    runs across ranks: tests/test_torch_mesh_algorithms.py."""
    from aesmc_tpu_torch.parallel import collectives
    monkeypatch.setattr(collectives, "size", lambda group: 1)
    monkeypatch.setattr(collectives, "all_reduce",
                        lambda x, group, op="sum": x.clone())
    logw, x = _inputs(2, 64, 2, seed=3)
    kwargs = dict(epsilon=0.5, num_iterations=20)
    got, zeros = ot.distributed_ot_resample(torch.tensor(logw),
                                            torch.tensor(x), None, **kwargs)
    want, _ = ot.ot_resample_blocked(torch.tensor(logw), torch.tensor(x),
                                     block_size=64, **kwargs)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)
    assert not zeros.any()
    for g, w in zip(
            _grads(lambda lw, xx: ot.distributed_ot_resample(
                lw, xx, None, **kwargs), logw, x),
            _grads(lambda lw, xx: ot.ot_resample_blocked(
                lw, xx, block_size=64, **kwargs), logw, x)):
        np.testing.assert_allclose(g, w, atol=GRAD_ATOL)


T, B, K = 6, 3, 32


def _lgssm():
    jax_comps = (jax_lgssm.Initial(0.0, 1.0),
                 jax_lgssm.Transition.create(0.9, 1.0),
                 jax_lgssm.Emission.create(1.0, 0.5),
                 jax_lgssm.Proposal.create(1.0, 1.0, jax.random.PRNGKey(2)))
    return jax_comps, lgssm.from_numpy(lgssm_params(jax_comps), device="cpu")


@pytest.mark.parametrize("rank", [None, 8])
def test_infer_ot_replays_jax(rank):
    jax_comps, comps = _lgssm()
    obs = simulate(9, T, B)
    key = jax.random.PRNGKey(5)
    kwargs = dict(resampling_method="ot", ot_num_iterations=15,
                  ot_rank=rank)
    want = jax_inference.infer(
        "smc", jnp.asarray(obs), *jax_comps, K, key=key,
        return_log_marginal_likelihood=True, return_latents=False, **kwargs)
    keys = jax.random.split(key, (T, 2))
    normals = [normal_draw(keys[0, 1], (K,), (B,), batch_expanded=True)]
    jitter = []
    for t in range(1, T):
        if rank is not None:
            jitter += _lowrank_noise(keys[t, 0], B, K, rank).normals
        jitter.append(tensor(normal_draw(keys[t, 1], (), (B, K))))
    noise = ReplayNoise(normals=normals)
    noise.normals += jitter
    with torch.no_grad():
        got = inference.infer("smc", tensor(obs), *comps, K, noise=noise,
                              return_log_marginal_likelihood=True,
                              return_latents=False, **kwargs)
    assert noise.exhausted()
    np.testing.assert_allclose(got["log_marginal_likelihood"].numpy(),
                               np.asarray(want["log_marginal_likelihood"]),
                               atol=1e-4)
    np.testing.assert_allclose(got["last_latent"].numpy(),
                               np.asarray(want["last_latent"]), atol=1e-4)


def test_aesmc_loss_through_ot_has_gradients():
    _, comps = _lgssm()
    obs = tensor(simulate(10, T, B))
    for rank in (None, 8):
        loss = losses.get_loss(obs, K, "aesmc", *comps,
                               noise=_seeded(), resampling_method="ot",
                               ot_num_iterations=10, ot_rank=rank)
        loss.backward()
        grads = [p.grad for p in comps[1].parameters()]
        assert bool(torch.isfinite(loss)) and grads
        assert all(bool(torch.isfinite(g).all()) for g in grads)
        assert sum(float(g.abs().sum()) for g in grads) > 0
        for p in comps[1].parameters():
            p.grad = None


def _seeded():
    from aesmc_tpu_torch.noise import NoiseSource
    return NoiseSource.seeded(0, "cpu")


@pytest.mark.parametrize("kwargs,match", [
    (dict(return_latents=True), "transports particles"),
    (dict(return_latents=False, return_ancestral_indices=True),
     "transports particles"),
    (dict(return_latents=False, history_window=2), "history_window"),
    (dict(return_latents=False, resampling_criterion=0.5), "ESS-adaptive"),
    (dict(return_latents=False, lookahead=lambda **kw: 0.0),
     "lookahead"),
])
def test_infer_ot_validation(kwargs, match):
    _, comps = _lgssm()
    with pytest.raises(ValueError, match=match):
        inference.infer("smc", tensor(simulate(1, T, B)), *comps, K,
                        noise=_seeded(), resampling_method="ot", **kwargs)
