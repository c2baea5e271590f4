"""Writes `twisted_bouncing_ball_obs.npy`: the observations of the JAX
package's deep-twist tests (`tests/test_twisted.py`, `_bb_setup`: the
bouncing ball of `make_model(PRNGKey(0))`, T = 32, B = 4, drawn by
`statistics.sample_from_prior` with `PRNGKey(0)`), `[32, 4, 32]` float32.

`chip_smoke.py`'s phase 33 holds the port to that test's bars on these
observations, on a card without JAX. Run from the repository root:

    JAX_PLATFORMS=cpu python tests/data/make_twisted_fixture.py
"""

import pathlib

import jax
import numpy as np

from aesmc_tpu import statistics
from aesmc_tpu.models import bouncing_ball

PATH = pathlib.Path(__file__).with_name("twisted_bouncing_ball_obs.npy")
T, B = 32, 4


def observations():
    initial, transition, emission, _ = bouncing_ball.make_model(
        jax.random.PRNGKey(0))
    _, obs = statistics.sample_from_prior(initial, transition, emission, T,
                                          B, key=jax.random.PRNGKey(0))
    return np.asarray(obs, np.float32)


if __name__ == "__main__":
    np.save(PATH, observations())
    print(f"wrote {PATH}")
