"""`BENCHMARK.json` and the files it names: loading and validation.

`load(root)` reads the benchmark and returns a `Spec`; `validate(spec,
root)` lists every way the files break the benchmark's contract (an empty
list when they keep it). A cell's file, a configuration's file and a
per-layer metric's reader are found by name alone, so a later cell or
metric is new files plus new entries in `BENCHMARK.json`.
"""

from __future__ import annotations

import json
import pathlib
import re
from dataclasses import dataclass

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
RELPATH = re.compile(r"[A-Za-z0-9_./-]{1,200}")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
WORKLOAD_KEYS = {"name", "config", "traffic", "chips", "why"}
END_TO_END_KEYS = {"name", "unit", "better", "bound", "source"}
PER_LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}
SOURCES_END_TO_END = {"host_clock", "device_trace"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
# The keys of a cell's own file (`workloads/<cell>.json`).
CELL_FILE_KEYS = {"config", "driver", "chips", "why", "traffic", "check",
                  "trace"}
# A width never cut (the contract's rule on `reduced`).
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|head|"
                   r"expansion|_dim$|_rank$|per_tok)")
MAX_BYTES = 64 * 1024
BENCH_DIR = "portbench"


@dataclass
class Spec:
    data: dict
    root: pathlib.Path

    def entry(self, kind: str, name: str) -> dict:
        for item in self.data[kind]:
            if item["name"] == name:
                return item
        raise KeyError(f"no {kind[:-1]} named {name!r} in BENCHMARK.json")

    def cell(self, name: str) -> dict:
        """The cell's file, with its `BENCHMARK.json` entry under 'entry'
        and its configuration's file under 'config_data'."""
        entry = self.entry("workloads", name)
        cell = read_json(self.root / BENCH_DIR / "workloads" / f"{name}.json")
        config = self.entry("configs", entry["config"])
        cell["entry"] = entry
        cell["config_data"] = read_json(self.root / config["file"])
        return cell

    def end_to_end(self, cell: str) -> list:
        """The end-to-end metrics reported in ``cell``."""
        return [m for m in self.data["end_to_end"]
                if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> list:
        """The per-layer metrics read in ``cell``'s traced run."""
        return [m for m in self.data["per_layer"]
                if cell in m.get("workloads", [cell])]


def read_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load(root) -> Spec:
    root = pathlib.Path(root)
    return Spec(read_json(root / "BENCHMARK.json"), root)


def _line(text, limit=200) -> bool:
    return (isinstance(text, str) and 1 <= len(text) <= limit and
            "\n" not in text and "\r" not in text and "\t" not in text)


def _name(text) -> bool:
    return isinstance(text, str) and NAME.fullmatch(text) is not None


def validate(spec: Spec, root=None) -> list:
    """Every breach of the contract in ``spec`` and the files it names."""
    root = pathlib.Path(root or spec.root)
    data, errors = spec.data, []
    if (root / "BENCHMARK.json").exists() and \
            (root / "BENCHMARK.json").stat().st_size > MAX_BYTES:
        errors.append("BENCHMARK.json is over 64 KiB")
    if set(data) != TOP_KEYS:
        errors.append(f"top-level keys {sorted(data)} != {sorted(TOP_KEYS)}")
        return errors
    command, paths = data["command"], data["paths"]
    if not (isinstance(command, list) and 1 <= len(command) <= 32 and
            all(_line(w) for w in command)):
        errors.append("command: 1 to 32 words of 1 to 200 characters")
    if not (isinstance(paths, list) and 1 <= len(paths) <= 16):
        errors.append("paths: 1 to 16 directories")
        paths = []
    for path in paths:
        if (not isinstance(path, str) or not RELPATH.fullmatch(path) or
                path.startswith("/") or ".." in path.split("/")):
            errors.append(f"path {path!r} is not a plain relative path")
    for word in command[1:] if isinstance(command, list) else []:
        if "/" in word and not any(word == p or word.startswith(p + "/")
                                   for p in paths):
            errors.append(f"command word {word!r} lies outside paths")
        if word.startswith("/") or ".." in word.split("/"):
            errors.append(f"command word {word!r} leaves the checkout")
    if not (isinstance(data["run_seconds"], int) and
            1 <= data["run_seconds"] <= 51):
        errors.append("run_seconds: a whole number from 1 to 51")

    names = set()

    def unique(kind, item):
        name = item.get("name")
        if not _name(name):
            errors.append(f"{kind} name {name!r} is not a valid name")
        elif name in names:
            errors.append(f"name {name!r} is used twice")
        names.add(name)

    configs = data["configs"]
    if not 1 <= len(configs) <= 24:
        errors.append("configs: 1 to 24")
    files = set()
    for config in configs:
        unique("config", config)
        if set(config) != CONFIG_KEYS:
            errors.append(f"config {config.get('name')}: keys "
                          f"{sorted(config)}")
            continue
        if not _line(config["source"]) or not _line(config["why"]):
            errors.append(f"config {config['name']}: source and why are "
                          "1 to 200 characters on one line")
        file = config["file"]
        if file in files or not any(file.startswith(p + "/") for p in paths):
            errors.append(f"config {config['name']}: file {file!r} is not "
                          "its own file under paths")
        files.add(file)
        if not (root / file).is_file():
            errors.append(f"config {config['name']}: {file} is missing")
        reduced = config["reduced"]
        if not isinstance(reduced, list) or len(reduced) > 16:
            errors.append(f"config {config['name']}: reduced has at most 16")
        for key in reduced if isinstance(reduced, list) else []:
            if not _name(key) or WIDTH.search(key):
                errors.append(f"config {config['name']}: reduced key "
                              f"{key!r} is not a cut of depth or scale")
    config_names = {c.get("name") for c in configs}

    cells = data["workloads"]
    if not 1 <= len(cells) <= 24:
        errors.append("workloads: 1 to 24")
    pairs = set()
    for cell in cells:
        unique("workload", cell)
        if set(cell) != WORKLOAD_KEYS:
            errors.append(f"workload {cell.get('name')}: keys {sorted(cell)}")
            continue
        if cell["config"] not in config_names:
            errors.append(f"workload {cell['name']}: no config "
                          f"{cell['config']!r}")
        if not _name(cell["traffic"]):
            errors.append(f"workload {cell['name']}: bad traffic name")
        if cell["chips"] not in (1, 4):
            errors.append(f"workload {cell['name']}: chips is 1 or 4")
        if not _line(cell["why"]):
            errors.append(f"workload {cell['name']}: why on one line, 1 to "
                          "200 characters")
        pair = (cell["config"], cell["traffic"])
        if pair in pairs:
            errors.append(f"workload {cell['name']}: {pair} appears twice")
        pairs.add(pair)
        errors += _cell_file_errors(root, cell)
    four = sum(1 for c in cells if c.get("chips") == 4)
    if four > max(1, len(cells) // 4):
        errors.append(f"{four} cells ask for 4 chips")
    used = {c.get("config") for c in cells}
    for name in config_names - used:
        errors.append(f"config {name} is used by no cell")
    cell_names = {c.get("name") for c in cells}

    e2e = data["end_to_end"]
    if not 1 <= len(e2e) <= 16:
        errors.append("end_to_end: 1 to 16")
    for metric in e2e:
        unique("metric", metric)
        keys = set(metric) - {"workloads"}
        if keys != END_TO_END_KEYS:
            errors.append(f"metric {metric.get('name')}: keys "
                          f"{sorted(metric)}")
            continue
        errors += _metric_errors(metric, cell_names)
        if metric["source"] not in SOURCES_END_TO_END:
            errors.append(f"metric {metric['name']}: an end-to-end metric "
                          "comes from host_clock or device_trace")
        bound = metric["bound"]
        if not (isinstance(bound, (int, float)) and 0.01 <= bound <= 0.25):
            errors.append(f"metric {metric['name']}: bound in [0.01, 0.25]")
    if "setup_s" not in {m.get("name") for m in e2e}:
        errors.append("end_to_end lacks setup_s")
    e2e_names = {m.get("name") for m in e2e}

    layers = data["per_layer"]
    if not 1 <= len(layers) <= 128:
        errors.append("per_layer: 1 to 128")
    for metric in layers:
        unique("metric", metric)
        keys = set(metric) - {"workloads"}
        if keys != PER_LAYER_KEYS:
            errors.append(f"metric {metric.get('name')}: keys "
                          f"{sorted(metric)}")
            continue
        errors += _metric_errors(metric, cell_names)
        if not _line(metric["layer"]):
            errors.append(f"metric {metric['name']}: layer on one line")
        if metric["moves"] not in e2e_names - {"setup_s"}:
            errors.append(f"metric {metric['name']}: moves "
                          f"{metric['moves']!r}, no end-to-end metric")
        reader = root / BENCH_DIR / "metrics" / f"{metric['name']}.py"
        if not reader.is_file():
            errors.append(f"metric {metric['name']}: no reader {reader.name}")
        moved = next((m for m in e2e if m.get("name") == metric["moves"]),
                     None)
        if moved is not None:
            for cell in metric.get("workloads", cell_names):
                if cell not in moved.get("workloads", cell_names):
                    errors.append(f"metric {metric['name']}: cell {cell} "
                                  f"does not report {metric['moves']}")
        if metric["name"].endswith("_roofline") or "_roofline." in \
                metric["name"]:
            if metric["unit"] != "%":
                errors.append(f"metric {metric['name']}: a roofline is in %")

    for cell in cell_names:
        reported = [m["name"] for m in e2e
                    if cell in m.get("workloads", cell_names)]
        if "setup_s" not in reported or len(reported) < 2:
            errors.append(f"cell {cell} reports setup_s and one other "
                          "end-to-end metric")
        if not any(cell in m.get("workloads", cell_names) for m in layers):
            errors.append(f"cell {cell} reports no per-layer metric")
    return errors


def _metric_errors(metric, cell_names) -> list:
    errors = []
    if not isinstance(metric.get("unit"), str) or \
            not UNIT.fullmatch(metric["unit"]):
        errors.append(f"metric {metric['name']}: bad unit {metric['unit']!r}")
    if metric.get("better") not in ("lower", "higher"):
        errors.append(f"metric {metric['name']}: better is lower or higher")
    if metric.get("source") not in SOURCES:
        errors.append(f"metric {metric['name']}: bad source")
    if "workloads" in metric:
        cells = metric["workloads"]
        if not isinstance(cells, list) or not cells or \
                not set(cells) <= cell_names:
            errors.append(f"metric {metric['name']}: workloads name cells "
                          "that do not exist")
    return errors


def _cell_file_errors(root, entry) -> list:
    path = root / BENCH_DIR / "workloads" / f"{entry['name']}.json"
    if not path.is_file():
        return [f"workload {entry['name']}: no file {path.name}"]
    cell, errors = read_json(path), []
    if set(cell) != CELL_FILE_KEYS:
        errors.append(f"{path.name}: keys {sorted(cell)} != "
                      f"{sorted(CELL_FILE_KEYS)}")
        return errors
    for key in ("config", "chips", "why"):
        if cell[key] != entry[key]:
            errors.append(f"{path.name}: {key} differs from BENCHMARK.json")
    if cell["traffic"].get("name") != entry["traffic"]:
        errors.append(f"{path.name}: traffic name differs from "
                      "BENCHMARK.json")
    if not (root / BENCH_DIR / "drivers" / f"{cell['driver']}.py").is_file():
        errors.append(f"{path.name}: no driver {cell['driver']!r}")
    limits = cell["check"].get("limits", {})
    if not limits or not all(isinstance(v, (int, float))
                             for v in limits.values()):
        errors.append(f"{path.name}: check.limits names each number "
                      "compared and its limit")
    return errors
