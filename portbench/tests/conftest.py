"""The harness's CPU tests: small sizes, two threads a process."""

import pathlib
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

torch.set_num_threads(2)


def load_spec():
    """The benchmark as `BENCHMARK.json` lists it."""
    from portbench.harness import spec as spec_mod
    return spec_mod.load(ROOT)
