"""`train.train_on_device`'s CUDA graph, on the card only.

Marked `cuda`: without a card the test skips. It imports nothing of JAX,
so that it runs where the card is (the repository's `conftest.py`
imports JAX, hence `--noconftest`):

    python -m pytest --noconftest -o addopts= tests/test_torch_graph.py

8 steps, 3 of them the warm-up and 5 graph replays, equal 8 eager
`make_train_step` steps from the same seed bit for bit (also with soft
resampling, K3 and K2, and on the dense route, a matmul a step), and
with lr 0 every replay draws fresh noise (every replay's loss differs).
Graphed runs with a matmul leave no cuBLAS workspace behind.

The streaming filter (`online`): a step captured in a CUDA graph
(`online.CapturedStep`), replayed over a stream of observations, equals
eager `step_fn` calls from the same generator state bit for bit, and so
does a captured `batched_steps`; the step exported with `torch.export`
and loaded back equals the live step and launches K1 inside the program.

The RBPF at Do = 9 (the innovation solve's Cholesky branch) captured in a
CUDA graph equals an eager call from the same generator state (a captured
`torch.cholesky_solve` aborted the process there).
"""

import pytest
import torch

from torch.utils import _pytree as pytree

from aesmc_tpu_torch import distributions, online, rbpf, statistics, train
from aesmc_tpu_torch.models import lgssm
from aesmc_tpu_torch.noise import NoiseSource
from aesmc_tpu_torch.ops import normalized_cdf_cuda, resample_cuda
import torch_threads  # noqa: F401  (caps PyTorch's threads)

T, B, K, STEPS = 5, 2, 16, 8


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the step is captured in a CUDA "
                    "graph only on the card")
    return torch.device("cuda", 0)


def _run(dev, fused, lr, **kwargs):
    comps = tuple(m.to(dev) for m in (
        lgssm.Initial(0.0, 1.0), lgssm.Transition(0.0, 1.0),
        lgssm.Emission(0.3, 0.1),
        lgssm.Proposal.create(1.0, 1.0, torch.Generator().manual_seed(0))))
    generative = tuple(m.to(dev) for m in (
        lgssm.Initial(0.0, 1.0), lgssm.Transition(0.9, 1.0),
        lgssm.Emission(1.0, 0.1)))
    optimizer = torch.optim.Adam(train.get_chained_params(*comps), lr=lr,
                                 capturable=True)
    noise = NoiseSource.seeded(5, dev)
    if fused:
        return train.train_on_device(
            *comps, K, "aesmc", generative, T, B, STEPS, optimizer=optimizer,
            noise=noise, steps_per_call=4, **kwargs)[1]
    step = train.make_train_step(K, "aesmc", optimizer, **kwargs)
    losses = []
    for _ in range(STEPS):
        with torch.no_grad():
            _, obs = statistics.sample_from_prior(*generative, T, B, noise)
        losses.append(step(comps, obs, noise))
    return torch.stack(losses)


@pytest.mark.cuda
def test_graphed_steps_equal_eager(card):
    assert torch.equal(_run(card, True, 1e-2), _run(card, False, 1e-2))
    replays = _run(card, True, 0.0)[train.WARMUP_STEPS:].tolist()
    assert len(set(replays)) == len(replays)


@pytest.mark.cuda
@pytest.mark.parametrize("kwargs", [
    dict(resampling_method="soft", soft_resampling_alpha=0.5),
    dict(resampling_implementation="torch")])
def test_graphed_soft_and_dense_steps_equal_eager(card, kwargs):
    assert torch.equal(_run(card, True, 1e-2, **kwargs),
                       _run(card, False, 1e-2, **kwargs))


@pytest.mark.cuda
def test_graphed_matmul_steps_keep_no_blas_workspace(card):
    _run(card, True, 1e-2, resampling_implementation="torch")
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    for _ in range(3):
        _run(card, True, 1e-2, resampling_implementation="torch")
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() - before < 2 ** 20


def _serving(dev, **kwargs):
    comps = tuple(m.to(dev) for m in (
        lgssm.Initial(0.0, 1.0), lgssm.Transition(0.9, 1.0),
        lgssm.Emission(1.0, 0.2),
        lgssm.Proposal.create(1.0, 1.0, torch.Generator().manual_seed(0))))
    with torch.no_grad():
        _, obs = statistics.sample_from_prior(
            *comps[:3], 12, B, NoiseSource.seeded(1, dev))
    init_fn, step_fn = online.make_online_filter(*comps, K, **kwargs)
    return init_fn, step_fn, obs


def _same(a, b):
    la, lb = pytree.tree_leaves(a), pytree.tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [None, 4])
def test_captured_serving_step_equals_eager(card, batch):
    init_fn, step_fn, obs = _serving(card, return_ancestors=True)
    noise = NoiseSource.seeded(7, card)
    with torch.no_grad():
        state = init_fn(obs[0], noise)
        step = step_fn if batch is None else online.batched_steps(step_fn)
        chunks = ([obs[t] for t in range(1, len(obs))] if batch is None else
                  [obs[t:t + batch] for t in range(1, len(obs) - batch + 1,
                                                    batch)])
        captured = online.CapturedStep(step, state, chunks[0], noise)
        start = noise.generator.get_state()
        replayed = [pytree.tree_map(torch.clone, captured(c))
                    for c in chunks]
        noise.generator.set_state(start)
        eager = []
        for c in chunks:
            state, info = step(state, c, noise)
            eager.append(info)
    assert _same(replayed, eager)
    assert _same(online._fields(captured.state), online._fields(state))


@pytest.mark.cuda
def test_exported_step_launches_k1_and_equals_live_step(card):
    init_fn, step_fn, obs = _serving(card)
    noise = NoiseSource.seeded(8, card)
    with torch.no_grad():
        state = init_fn(obs[0], noise)
        step = online.load_step(online.export_step(step_fn, state, obs[1]))
        start = noise.generator.get_state()
        live = step_fn(state, obs[1], noise)
        noise.generator.set_state(start)
        before = resample_cuda.LAUNCHES
        cdf_before = normalized_cdf_cuda.LAUNCHES
        loaded = step(state, obs[1], noise)
        torch.cuda.synchronize()
    assert resample_cuda.LAUNCHES == before + 1
    # The CDF kernel's operator is in the program too.
    assert normalized_cdf_cuda.LAUNCHES == cdf_before + 1
    assert _same((online._fields(live[0]), live[1]),
                 (online._fields(loaded[0]), loaded[1]))


@pytest.mark.cuda
def test_graphed_rbpf_cholesky_branch_equals_eager(card):
    do, d = 9, 2
    generator = torch.Generator(device=card).manual_seed(3)
    obs = torch.randn(T, B, do, generator=generator, device=card)
    c = torch.randn(do, d, generator=generator, device=card)
    r = 0.09 * torch.eye(do, device=card) + 0.01
    logits = torch.log(torch.tensor([[0.85, 0.15], [0.3, 0.7]],
                                    device=card))
    scales = torch.tensor([0.95, 0.2], device=card)
    eye = torch.eye(d, device=card)
    noise = NoiseSource.seeded(4, card)

    def call():
        return rbpf.rbpf(
            obs, lambda: distributions.Categorical(logits=logits[0]),
            lambda previous_latents, time: distributions.Categorical(
                logits=logits[previous_latents[0].long()]),
            lambda u0: (torch.zeros(d, device=card), eye),
            lambda u, time: (scales[u.long()][..., None, None] * eye,
                             torch.zeros(d, device=card), 0.5 * eye),
            lambda u, time: (c, torch.zeros(do, device=card), r),
            K, noise=noise)["log_marginal_likelihood"]

    train._warm_up(call, 1)
    graph, out = train._capture(call, noise.generator)
    state = noise.generator.get_state()
    graph.replay()
    replayed = out.clone()
    noise.generator.set_state(state)
    assert torch.isfinite(replayed).all()
    assert torch.equal(replayed, call())
