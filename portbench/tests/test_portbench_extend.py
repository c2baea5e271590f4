"""A later configuration, cell and per-layer metric are new files and new
entries in BENCHMARK.json, run through the harness without a change to
any file it already has: a dummy cell with its own driver, configuration,
model and reference and a dummy metric, all defined in this test file;
and a new configuration kind (lgssm's model, reference and counts modules
copied under another name) whose cell runs the filter cell's unchanged
driver, with a reader of the driver's spans."""

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
SPAN_METRIC = '''
def read(reading):
    propose = reading.records.get("spans", {}).get("aesmc.smc.propose")
    return None if propose is None else float(propose["occurrences"])
'''
# The new configuration's filter cell, at a size the CPU runs quickly.
TWIN_STEPS = 12
TWIN_TRAFFIC = {"name": "smc-logz-12x2x64", "num_timesteps": TWIN_STEPS,
                "batch_size": 2, "num_particles": 64,
                "resampling_method": "systematic", "max_calls": 100,
                "warmup_seconds": 0.05}
# Files the checkout gains, under portbench/.
NEW_FILES = [
    "drivers/dummy_sum.py", "reference/dummy.py", "models/dummy.py",
    "metrics/dummy_items.py", "configs/dummy.json",
    "workloads/dummy-cell.json", "models/twin.py", "reference/twin.py",
    "counts/twin.py", "configs/twin.json", "workloads/twin-filter.json",
    "metrics/propose_spans.twin.py"]


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
    for kind in ("models", "reference", "counts"):
        shutil.copy(bench / kind / "lgssm.py", bench / kind / "twin.py")
    config = json.loads((bench / "configs" / "lgssm.json").read_text())
    config["name"] = "twin"
    config["model"]["kind"] = "twin"
    (bench / "configs" / "twin.json").write_text(json.dumps(config))
    (bench / "workloads" / "twin-filter.json").write_text(json.dumps({
        "config": "twin", "driver": "infer_graph", "chips": 1,
        "why": "a test's cell of a new configuration", "traffic":
        TWIN_TRAFFIC, "check": {"sample": 8, "limits": {"logz_gap": 1.5}},
        "trace": {"seconds": 0.05}}))
    (bench / "metrics" / "propose_spans.twin.py").write_text(SPAN_METRIC)
    data = json.loads((ROOT / "BENCHMARK.json").read_text())
    data["configs"] += [
        {"name": "dummy", "source": "https://example.org",
         "file": "portbench/configs/dummy.json", "reduced": [],
         "why": "a test's configuration"},
        {"name": "twin", "source": "https://example.org",
         "file": "portbench/configs/twin.json", "reduced": [],
         "why": "a test's copy of a configuration under a new kind"}]
    data["workloads"] += [
        {"name": "dummy-cell", "config": "dummy", "traffic": "sum-1k",
         "chips": 1, "why": "a test's cell"},
        {"name": "twin-filter", "config": "twin",
         "traffic": TWIN_TRAFFIC["name"], "chips": 1,
         "why": "a test's cell of a new configuration"}]
    for metric in data["end_to_end"]:
        if metric["name"] == "infer_call_ms":
            metric["workloads"] += ["dummy-cell", "twin-filter"]
    data["per_layer"] += [
        {"name": "dummy_items", "unit": "items", "better": "higher",
         "source": "host_clock", "layer": "a test's layer",
         "moves": "infer_call_ms", "workloads": ["dummy-cell"]},
        {"name": "propose_spans.twin", "unit": "spans", "better": "lower",
         "source": "program_span",
         "layer": "model algebra: models/*.py, distributions.py",
         "moves": "infer_call_ms", "workloads": ["twin-filter"]}]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(data))
    return tmp_path


def test_new_files_only(checkout):
    for name in NEW_FILES:
        assert not (ROOT / "portbench" / name).exists(), name
        assert (checkout / "portbench" / name).is_file(), name
    kept = [path for path in (ROOT / "portbench").rglob("*")
            if path.is_file() and not {".cache", "__pycache__"} &
            set(path.relative_to(ROOT).parts)]
    assert {p.parent.name for p in kept} >= {
        "drivers", "metrics", "configs", "workloads", "models",
        "reference", "counts", "harness"}
    for path in kept:
        copy = checkout / path.relative_to(ROOT)
        assert copy.read_bytes() == path.read_bytes(), path
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


@pytest.mark.parametrize("trace", [False, True])
def test_new_configuration_runs(checkout, trace):
    spec = spec_mod.load(checkout)
    line = runner.run_cell(spec, "twin-filter", 2 ** 31 + 7, 0.05, trace,
                           "cpu", time.perf_counter())
    assert line["correct"], line["checks"]
    assert set(line["checks"]) == {"logz_gap"}
    if trace:
        # The eager call proposes once a step after the first.
        assert line["metrics"] == {"propose_spans.twin": {
            "value": float(TWIN_STEPS - 1), "unit": "spans"}}
    else:
        assert set(line["metrics"]) == {"infer_call_ms", "setup_s"}
