"""BENCHMARK.json and the files it names keep the benchmark's contract."""

import copy
import json
import math

import pytest

from portbench.harness import spec as spec_mod
from portbench.tests.conftest import ROOT, load_spec


@pytest.fixture(scope="module")
def spec():
    return spec_mod.load(ROOT)


def test_benchmark_keeps_the_contract(spec):
    assert spec_mod.validate(spec) == []


# What accepted benchmarks list: later ones may list more, never less.
ACCEPTED = {
    "workloads": {"lgssm-filter", "lgssm-serve"},
    "end_to_end": {"infer_call_ms", "serve_obs_p95_ms", "setup_s"},
    "per_layer": {
        "serve_obs_p50_ms", "kernels_per_call.infer", "k1_roofline.infer",
        "k1_roofline.serve", "device_idle.infer", "device_idle.serve",
        "step_mfu.infer", "step_mfu.serve", "cdf_build_us.infer",
        "resample_us.infer", "propose_weigh_us.infer",
        "propose_weigh_kernels.infer"},
}


def test_listed_cells_and_metrics(spec):
    for kind, accepted in ACCEPTED.items():
        assert {m["name"] for m in spec.data[kind]} >= accepted, kind
    readers = {p.stem for p in (ROOT / "portbench" / "metrics").glob("*.py")}
    assert {m["name"] for m in spec.data["per_layer"]} <= readers


@pytest.mark.parametrize("cell", [c["name"] for c in
                                  load_spec().data["workloads"]])
def test_cell_files(cell):
    data = load_spec().cell(cell)
    assert data["config_data"]["name"] == data["config"]
    assert (ROOT / "portbench" / "drivers" / f"{data['driver']}.py").is_file()
    # The numbers compared are the ones the cell's own file names, each
    # with a finite limit of its own.
    limits = data["check"]["limits"]
    assert limits and all(spec_mod._name(name) for name in limits)
    assert all(isinstance(v, (int, float)) and math.isfinite(v) and v >= 0
               for v in limits.values())


@pytest.mark.parametrize("name,ok", [
    ("lgssm-filter", True), ("k1_roofline.infer", True), ("_x", True),
    ("a" * 64, True), ("a" * 65, False), ("has space", False),
    ("a/b", False), ("a,b", False), (".x", False), ("µs", False)])
def test_name_rule(name, ok):
    assert spec_mod._name(name) is ok


@pytest.mark.parametrize("unit,ok", [
    ("ms", True), ("tokens/s", True), ("%", True), ("TFLOP/s", True),
    ("us", True), ("µs", False), ("tokens per second", False),
    ("a" * 17, False), ("", False)])
def test_unit_rule(unit, ok):
    assert (spec_mod.UNIT.fullmatch(unit) is not None) is ok


def _broken(spec, change):
    data = copy.deepcopy(spec.data)
    change(data)
    return spec_mod.validate(spec_mod.Spec(data, ROOT), ROOT)


@pytest.mark.parametrize("what,change", [
    ("extra key", lambda d: d.update(extra=1)),
    ("bound too wide", lambda d: d["end_to_end"][0].update(bound=0.3)),
    ("bound too tight", lambda d: d["end_to_end"][0].update(bound=0.001)),
    ("no setup_s", lambda d: d["end_to_end"].pop()),
    ("run_seconds", lambda d: d.update(run_seconds=52)),
    ("why on two lines", lambda d: d["workloads"][0].update(why="a\nb")),
    ("a width cut", lambda d: d["configs"][0].update(
        reduced=["hidden_dim"])),
    ("unknown cell", lambda d: d["per_layer"][0].update(
        workloads=["nope"])),
    ("metric without reader", lambda d: d["per_layer"].append(dict(
        d["per_layer"][0], name="no_such_metric"))),
    ("duplicate name", lambda d: d["per_layer"].append(
        d["per_layer"][0])),
    ("moves setup_s", lambda d: d["per_layer"][0].update(moves="setup_s")),
    ("metric key", lambda d: d["per_layer"][0].update(why="x")),
    ("path leaves", lambda d: d.update(paths=["../x"])),
    ("pair twice", lambda d: d["workloads"].append(dict(
        d["workloads"][0], name="twin"))),
])
def test_breaches_are_found(spec, what, change):
    assert _broken(spec, change), what


def test_cell_file_must_match(spec, tmp_path):
    import shutil
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench")
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    path = tmp_path / "portbench" / "workloads" / "lgssm-filter.json"
    cell = json.loads(path.read_text())
    cell["chips"] = 4
    path.write_text(json.dumps(cell))
    errors = spec_mod.validate(spec_mod.load(tmp_path))
    assert any("chips differs" in e for e in errors)
