"""Runs one cell of the port's benchmark once and prints its result line.

    python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

The last line of standard output is one JSON object (`correct`,
`attempted`, `failed`, `metrics`, `device`, with --trace 1 `breakdown`,
and last `checks`, each number compared beside its limit); the numbers
compared are also the last lines of standard error. Without an NVIDIA
card, or without the program beside this folder, it prints no result and
exits with a code other than 0.
"""

import time

STARTED = time.perf_counter()

import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
# Python's bytecode of every module the run imports, torch's among them,
# is cached in a fixed folder inside the checkout: where the interpreter
# may not write beside the sources (PYTHONDONTWRITEBYTECODE, no
# __pycache__ there), every run would compile torch from its sources
# again, several seconds of set-up that swing with the host's load.
sys.pycache_prefix = str(ROOT / "portbench" / ".cache" / "pycache")
sys.dont_write_bytecode = False
sys.path.insert(0, str(ROOT))

from portbench.harness import runner  # noqa: E402

if __name__ == "__main__":
    sys.exit(runner.main(STARTED))
