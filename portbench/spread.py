"""Medians and spreads of a cell's runs, as the bounds are set from them.

    python3 portbench/spread.py RUNS.out [--set 6]

RUNS.out holds the result lines of one cell's runs (other lines are
skipped), the first set's runs first. For each end-to-end metric it
prints each set's median and spread (the distance between the first and
the third quartile of `statistics.quantiles(values, n=4)`, a share of the
median) and five times the wider spread, the bound that spread asks for.
"""

import argparse
import json
import pathlib
import statistics
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from portbench.harness import stats  # noqa: E402


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("runs")
    parser.add_argument("--set", type=int, default=6,
                        help="runs a set (default 6)")
    args = parser.parse_args(argv)
    lines = []
    for text in open(args.runs):
        try:
            line = json.loads(text)
        except ValueError:
            continue
        if isinstance(line, dict) and "setup_s" in line.get("metrics", {}):
            lines.append(line)
    sets = [lines[i:i + args.set] for i in range(0, len(lines), args.set)]
    sets = [s for s in sets if len(s) == args.set][:2]
    for name in lines[0]["metrics"]:
        spreads = []
        for i, runs in enumerate(sets):
            values = [r["metrics"][name]["value"] for r in runs]
            spreads.append(stats.spread(values))
            print(f"{name} set {i + 1}: median {statistics.median(values)!r}"
                  f" spread {spreads[-1]:.4%} values {values}")
        print(f"{name}: five times the wider spread {5 * max(spreads):.4%}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
