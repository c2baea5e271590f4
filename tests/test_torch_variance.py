"""The port's single-run genealogy variance estimators against the JAX
package's, on the same seeded ancestors and weights.

The inputs come from numpy (sorted random ancestors, as multinomial and
systematic resampling produce; identity rows, as ESS-adaptive runs
produce) and from a port filter run (LGSSM, T = 6, B = 3, K = 32).

Tolerances: eve indices and family counts exactly equal; the variance
estimates within 1e-6 relative and 1e-7 absolute (float32 softmax and
family sums in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aesmc_tpu import variance as jax_variance
from aesmc_tpu_torch import inference, variance
from aesmc_tpu_torch.models import lgssm
from aesmc_tpu_torch.noise import NoiseSource
from torch_replay import simulate

B, K = 3, 32


def _inputs(seed, steps, identity_rows=()):
    rng = np.random.RandomState(seed)
    anc = np.sort(rng.randint(0, K, size=(steps, B, K)), axis=-1)
    for t in identity_rows:
        anc[t] = np.arange(K)
    log_weight = (rng.randn(B, K) * 2.0).astype(np.float32)
    value = rng.randn(B, K, 2).astype(np.float32)
    return anc.astype(np.int32), log_weight, value


@pytest.mark.parametrize("steps,identity_rows", [(5, ()), (4, (1, 3)),
                                                 (0, ())])
def test_estimators_match_jax(steps, identity_rows):
    anc, log_weight, value = _inputs(steps, steps, identity_rows)
    t_anc, t_lw, t_value = (torch.tensor(x) for x in (anc, log_weight,
                                                      value))
    j_anc, j_lw, j_value = (jnp.asarray(x) for x in (anc, log_weight,
                                                     value))
    eve = variance.eve_indices(t_anc)
    assert eve.dtype == torch.int32
    np.testing.assert_array_equal(eve.numpy(),
                                  np.asarray(jax_variance.eve_indices(j_anc)))
    np.testing.assert_array_equal(
        variance.num_families(t_anc).numpy(),
        np.asarray(jax_variance.num_families(j_anc)))
    events = [None, steps - len(identity_rows),
              torch.tensor([1.0, 2.0, 0.0])]
    for m in events:
        j_m = None if m is None else (jnp.asarray(m.numpy())
                                      if isinstance(m, torch.Tensor) else m)
        np.testing.assert_allclose(
            variance.log_z_variance(t_lw, t_anc, m).numpy(),
            np.asarray(jax_variance.log_z_variance(j_lw, j_anc, j_m)),
            rtol=1e-6, atol=1e-7)
    for v, jv in ((t_value, j_value), (t_value[..., 0], j_value[..., 0])):
        got = variance.expectation_variance(v, t_lw, t_anc)
        want = np.asarray(jax_variance.expectation_variance(jv, j_lw, j_anc))
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


def test_filter_outputs_and_collapse():
    comps = lgssm.from_numpy({
        "initial": {"loc": 0.0, "scale": 1.0},
        "transition": {"mult": 0.9, "scale": 1.0},
        "emission": {"mult": 1.0, "scale": 0.5},
        "proposal": {"lin_0_weight": 0.5, "lin_0_bias": 0.0,
                     "lin_t_weight": [0.5, 0.5], "lin_t_bias": 0.0,
                     "scale_0": 1.0, "scale_t": 1.0}}, device="cpu")
    obs = torch.tensor(simulate(2, 6, B))
    out = inference.infer("smc", obs, *comps, K,
                          noise=NoiseSource.seeded(3, device="cpu"),
                          resampling_method="multinomial",
                          return_ancestral_indices=True)
    anc, lw = out["ancestral_indices"], out["log_weight"].detach()
    got = variance.log_z_variance(lw, anc)
    want = np.asarray(jax_variance.log_z_variance(
        jnp.asarray(lw.numpy()), jnp.asarray(anc.numpy())))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    assert bool(((got >= 0) & (got <= 1)).all())
    # Full collapse: every particle descends from particle 0.
    collapsed = torch.zeros((3, B, K), dtype=torch.int32)
    assert variance.num_families(collapsed).tolist() == [1] * B
    np.testing.assert_allclose(
        variance.log_z_variance(lw, collapsed).numpy(), np.ones(B),
        atol=1e-6)
    with pytest.raises(ValueError, match="T-1, batch, K"):
        variance.eve_indices(collapsed[0])
