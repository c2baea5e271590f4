"""The benchmark of `aesmc_tpu_torch` on NVIDIA cards.

One command runs one cell once and prints one JSON line:

    python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

Everything a cell needs is found by name: the cell's file in `workloads/`,
its configuration in `configs/`, the driver the cell names in `drivers/`,
the model builders in `models/`, the plain reference in `reference/`, and
one reader a per-layer metric in `metrics/`. `counts/` holds the
operations and bytes a kernel or a step needs, and the card's peaks.
"""
