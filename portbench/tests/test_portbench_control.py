"""The control of each cell's check, at a size a test run can hold: the
plain reference in the program's place at the configuration's precision
comes out correct under the tests' limits (`test_portbench_run.SMALL`),
and at the precision below it comes out not correct, judged as a run
judges (`checks.correct`). On the card the same runs at the cells' sizes
and limits set the cells' limits (`portbench/control.py`)."""

import pytest

from portbench import control
from portbench.harness import checks
from portbench.tests.conftest import load_spec
from portbench.tests.test_portbench_run import SMALL

SEEDS = (2 ** 31 + 21, 2 ** 31 + 22, 2 ** 31 + 23)


# Filter calls, or served observations, a control run makes.
CALLS = {"lgssm-filter": 8, "lgssm-serve": 1000}


def _correct(name, precision, seed, device="cpu"):
    spec = load_spec()
    return checks.correct(control.control(spec, name, seed, device,
                                          precision, CALLS[name],
                                          SMALL[name]))


@pytest.mark.parametrize("name", ["lgssm-filter", "lgssm-serve"])
@pytest.mark.parametrize("seed", SEEDS)
def test_control_fails_and_sound_reference_passes(name, seed):
    assert not _correct(name, None, seed)
    assert _correct(name, "float32", seed)
