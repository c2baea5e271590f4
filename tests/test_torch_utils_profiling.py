"""The port's MLP, pytree helper and profiling hooks against the JAX
package's.

Tolerances: the MLP's output within 1e-6 absolute of the JAX MLP's with
the same weights (float32 products in another order); `unstack` exactly
equal.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aesmc_tpu import profiling as jax_profiling
from aesmc_tpu.utils import mlp as jax_mlp
from aesmc_tpu.utils import pytree as jax_pytree
from aesmc_tpu_torch import profiling
from aesmc_tpu_torch.utils import MLP, unstack
from torch_replay import mlp_fields


@pytest.mark.parametrize("activation", ["tanh", "relu"])
def test_mlp_matches_jax(activation):
    net = jax_mlp.MLP.create((5, 7, 3), jax.random.PRNGKey(0),
                             activation=activation)
    port = MLP.from_numpy(**mlp_fields(net), activation=activation,
                          device="cpu")
    x = np.random.RandomState(0).randn(2, 4, 5).astype(np.float32)
    np.testing.assert_allclose(port(torch.tensor(x)).detach().numpy(),
                               np.asarray(net(jnp.asarray(x))), atol=1e-6)
    assert [tuple(w.shape) for w in port.weights] == [(5, 7), (7, 3)]


def test_mlp_create():
    net = MLP.create((6, 10, 4), torch.Generator().manual_seed(1),
                     device="cpu").requires_grad_(False)
    assert [tuple(w.shape) for w in net.weights] == [(6, 10), (10, 4)]
    assert float(net.weights[0].abs().max()) <= 1.0 / np.sqrt(6)
    assert float(net.weights[1].abs().max()) <= 1.0 / np.sqrt(10)
    assert all(float(b.abs().max()) == 0.0 for b in net.biases)
    assert len(list(net.parameters())) == 4
    with pytest.raises(ValueError, match="activation"):
        MLP.create((2, 2), activation="sigmoid", device="cpu")


def test_unstack_matches_jax():
    x = np.arange(24, dtype=np.float32).reshape(3, 2, 4)
    tree = {"a": x, "b": {"c": x[..., :2] * 2}}
    for axis in (0, 1):
        got = unstack({"a": torch.tensor(x),
                       "b": {"c": torch.tensor(x[..., :2] * 2)}}, axis)
        want = jax_pytree.unstack(jax.tree_util.tree_map(jnp.asarray, tree),
                                  axis)
        assert len(got) == len(want) == x.shape[axis]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g["a"].numpy(), np.asarray(w["a"]))
            np.testing.assert_array_equal(g["b"]["c"].numpy(),
                                          np.asarray(w["b"]["c"]))
    assert [t.shape for t in unstack(torch.tensor(x))] == [(2, 4)] * 3


def test_step_timer_matches_jax():
    ours = profiling.StepTimer(num_timesteps=10, batch_size=2,
                               num_particles=8)
    theirs = jax_profiling.StepTimer(num_timesteps=10, batch_size=2,
                                     num_particles=8)
    for timer in (ours, theirs):
        timer.tick(3)
        timer.tick()
    time.sleep(0.01)
    assert ours._ticks == theirs._ticks == 4
    assert ours.elapsed > 0.0 and ours.steps_per_sec > 0.0
    # Each property reads the clock anew: the ratio within 1%.
    ratio = ours.particle_steps_per_sec / ours.steps_per_sec
    assert ratio == pytest.approx(10 * 2 * 8, rel=1e-2)
    assert "4 steps" in ours.summary()
    assert "M particle-steps/s" in ours.summary()
    assert profiling.StepTimer().particle_steps_per_sec is None
    ours.reset()
    assert ours._ticks == 0


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "trace")) as prof:
        with profiling.annotate("matmul_region"):
            torch.ones(8, 8) @ torch.ones(8, 8)
    path = tmp_path / "trace" / "trace.json"
    assert path.exists() and path.stat().st_size > 0
    assert "matmul_region" in path.read_text()
    assert any("matmul_region" in e.key for e in prof.key_averages())
