"""A later configuration, cell and per-layer metric are new files and new
entries in BENCHMARK.json: here a dummy cell, its driver, configuration,
model and reference and a dummy metric, all defined in this test file,
run through the harness without a change to any file it already has."""

import json
import shutil
import time

import pytest

from portbench.harness import runner, spec as spec_mod
from portbench.tests.conftest import ROOT

DRIVER = '''
import time
import torch
from portbench.harness import checks, stats


class Driver:
    def __init__(self, ctx):
        self.ctx, self.items, self.attempted, self.failed = ctx, 0, 0, 0

    def setup(self):
        self.x = torch.arange(self.ctx.traffic["size"], dtype=torch.float64)

    def run(self, window, seconds):
        window.open()
        while True:
            self.total = float(self.x.sum())
            self.items += 1
            if time.perf_counter() - window.start >= seconds:
                break
        window.close()
        self.window_s, self.attempted = window.seconds, self.items

    def end_to_end(self):
        return {"infer_call_ms": stats.per_item_ms(self.window_s, self.items)}

    def records(self):
        return {"items": self.items}

    def release(self):
        self.x = None

    def check(self):
        exact = self.ctx.reference.total(self.ctx.traffic["size"])
        return checks.checks({"sum_gap": abs(self.total - exact)},
                             self.ctx.check["limits"])
'''
REFERENCE = '''
def total(n):
    return n * (n - 1) / 2
'''
METRIC = '''
def read(reading):
    return float(reading.records["items"])
'''


@pytest.fixture
def checkout(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    bench = tmp_path / "portbench"
    (bench / "drivers" / "dummy_sum.py").write_text(DRIVER)
    (bench / "reference" / "dummy.py").write_text(REFERENCE)
    (bench / "models" / "dummy.py").write_text("")
    (bench / "metrics" / "dummy_items.py").write_text(METRIC)
    (bench / "configs" / "dummy.json").write_text(json.dumps(
        {"name": "dummy", "model": {"kind": "dummy"}}))
    (bench / "workloads" / "dummy-cell.json").write_text(json.dumps({
        "config": "dummy", "driver": "dummy_sum", "chips": 1,
        "why": "a test's cell", "traffic": {"name": "sum-1k", "size": 1000},
        "check": {"limits": {"sum_gap": 0}}, "trace": {"seconds": 0.05}}))
    data = json.loads((ROOT / "BENCHMARK.json").read_text())
    data["configs"].append({"name": "dummy", "source": "https://example.org",
                            "file": "portbench/configs/dummy.json",
                            "reduced": [], "why": "a test's configuration"})
    data["workloads"].append({"name": "dummy-cell", "config": "dummy",
                              "traffic": "sum-1k", "chips": 1,
                              "why": "a test's cell"})
    for metric in data["end_to_end"]:
        if metric["name"] == "infer_call_ms":
            metric["workloads"].append("dummy-cell")
    data["per_layer"].append({
        "name": "dummy_items", "unit": "items", "better": "higher",
        "source": "host_clock", "layer": "a test's layer",
        "moves": "infer_call_ms", "workloads": ["dummy-cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(data))
    return tmp_path


def test_new_files_only(checkout):
    for kind in ("drivers", "metrics", "configs", "workloads"):
        for path in (ROOT / "portbench" / kind).iterdir():
            if path.is_file():
                copy = checkout / "portbench" / kind / path.name
                assert copy.read_bytes() == path.read_bytes()
    assert spec_mod.validate(spec_mod.load(checkout)) == []


@pytest.mark.parametrize("trace", [False, True])
def test_dummy_cell_runs(checkout, trace):
    spec = spec_mod.load(checkout)
    line = runner.run_cell(spec, "dummy-cell", 2 ** 31 + 3, 0.05, trace,
                           "cpu", time.perf_counter())
    assert line["correct"] and line["checks"] == {
        "sum_gap": {"value": 0.0, "limit": 0.0}}
    if trace:
        assert line["metrics"]["dummy_items"]["value"] >= 1
    else:
        assert set(line["metrics"]) == {"infer_call_ms", "setup_s"}
