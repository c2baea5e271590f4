"""One run of one cell: set-up, the timed window, the metrics, the check.

`main()` is the command line (`portbench/run.py`); `run_cell` does the run
on a given device and returns the result line as a dict, so that the
tests can drive a run on the CPU.

A cell's driver (`drivers/<name>.py`, named in the cell's file) is a
class `Driver(ctx)` with `setup()`, `run(window, seconds)` (which opens
and closes the `trace.Window`), `end_to_end()` ({metric: value}),
`records()` (what the per-layer readers read), `release()` (frees the
program's state), `check()` (a list of `checks.Check`) and the counts
`attempted` and `failed`. A per-layer metric's reader
(`metrics/<metric>.py`) is `read(reading)`, returning a number or None.

A configuration's modules are found by its file's `model.kind`, and every
driver reaches them through this contract alone, whatever the model:

- `models/<kind>.py`, the configuration as the port runs it:
  `filter_components(model, device)` gives (the components that
  `inference.infer` takes, the proposal's numbers);
  `observations(model, generator, T, B)` gives `[T, B]` observations on
  the generator's device; `proposal_params(model)` gives the proposal's
  numbers, which the control hands the reference's filters together with
  the model's numbers.
- `reference/<kind>.py`, plain PyTorch or numpy that imports nothing of
  the program: `model_params(config)` gives the data model's numbers;
  `exact_log_z(obs, params)` the exact log-Z `[B]` of observations
  `[T, B]`, `exact_terms(obs, params)` the exact log p(y_t | y_{<t})
  `[T, B]`; `filter_log_z(model, params, obs, K, draws)` and
  `stream(model, params, obs, K, draws)` are the plain filters that the
  control runs in the program's place.
- `counts/<kind>.py`: the work of the cells' items (`infer_call`,
  `serve_step`: operations and bytes; `k1_shape`), which readers divide
  by.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import pathlib
import sys
import time
from dataclasses import dataclass

from . import env, spec as spec_mod

ROOT = pathlib.Path(__file__).resolve().parents[2]


def load_module(root, kind: str, name: str):
    """``<root>/portbench/<kind>/<name>.py`` as a module (names may hold
    dots and dashes)."""
    path = pathlib.Path(root) / "portbench" / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} {name!r}: {path} is missing")
    key = "".join(c if c.isalnum() else "_" for c in str(path))
    module_name = f"portbench.{kind}._{key}"
    loaded = sys.modules.get(module_name)
    if loaded is not None:
        return loaded
    found = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(found)
    sys.modules[module_name] = module
    found.loader.exec_module(module)
    return module


def stream_seed(seed: int, stream: int) -> int:
    """A generator seed for stream ``stream`` of the run's ``seed``."""
    return (int(seed) * 6364136223846793005 + 1442695040888963407 *
            (stream + 1)) % (1 << 63)


@dataclass
class Context:
    """What a driver knows of its cell."""
    root: pathlib.Path
    name: str
    seed: int
    device: str
    config: dict
    traffic: dict
    check: dict
    trace: dict
    started: float = None

    def mark(self, what: str) -> None:
        """Notes on standard error how far the run has come, in seconds
        from the process's start (where set-up goes)."""
        if self.started is not None:
            print(f"portbench: {time.perf_counter() - self.started:.3f} s "
                  f"{what}", file=sys.stderr, flush=True)

    def generator(self, stream: int):
        import torch
        gen = torch.Generator(device=self.device)
        gen.manual_seed(stream_seed(self.seed, stream))
        return gen

    @property
    def model(self):
        """`portbench/models/<model>.py`: the configuration as the port
        runs it."""
        return load_module(self.root, "models", self.config["model"]["kind"])

    @property
    def reference(self):
        """`portbench/reference/<model>.py`: its plain reference."""
        return load_module(self.root, "reference",
                           self.config["model"]["kind"])


@dataclass
class Reading:
    """What a per-layer metric's reader reads: the traced window's
    `trace.TraceSummary`, the driver's records, and the cell."""
    ctx: Context
    summary: object
    records: dict

    @property
    def counts(self):
        """`portbench/counts/<model>.py`: the work of the cell's items."""
        return load_module(self.ctx.root, "counts",
                           self.ctx.config["model"]["kind"])


def _merge(base: dict, extra: dict) -> dict:
    out = dict(base)
    for key, value in (extra or {}).items():
        out[key] = (_merge(out[key], value)
                    if isinstance(value, dict) and isinstance(out.get(key),
                                                              dict)
                    else value)
    return out


def run_cell(spec, name: str, seed: int, seconds: float, trace: bool,
             device: str, started: float, overrides=None) -> dict:
    """Runs cell ``name`` once on ``device`` and returns its result line.
    ``overrides`` ({'traffic': {...}, 'check': {...}, 'trace': {...}})
    replace parts of the cell's file (the tests' small sizes)."""
    import torch

    from . import checks as checks_mod, trace as trace_mod

    cell = _merge(spec.cell(name), overrides or {})
    ctx = Context(root=spec.root, name=name, seed=seed, device=device,
                  config=cell["config_data"], traffic=cell["traffic"],
                  check=cell["check"], trace=cell["trace"], started=started)
    ctx.mark("torch imported")
    on_card = torch.device(device).type == "cuda"
    if on_card:
        env.float32_means_float32()
        torch.cuda.reset_peak_memory_stats()
    driver = load_module(spec.root, "drivers", cell["driver"]).Driver(ctx)
    ctx.mark("driver loaded")
    driver.setup()
    ctx.mark("driver set up")
    window = trace_mod.Window(traced=trace, device=device)
    driver.run(window, cell["trace"]["seconds"] if trace else seconds)
    setup_s = window.start - started
    memory_peak = torch.cuda.max_memory_allocated() if on_card else 0
    ctx.mark(f"window closed after {window.seconds:.3f} s")
    metrics, summary = {}, None
    if trace:
        summary = trace_mod.summarize(window.profiler)
        reading = Reading(ctx, summary, driver.records())
        for metric in spec.per_layer(name):
            value = load_module(spec.root, "metrics",
                                metric["name"]).read(reading)
            if value is not None:
                metrics[metric["name"]] = {"value": value,
                                           "unit": metric["unit"]}
    else:
        values = dict(driver.end_to_end(), setup_s=setup_s)
        for metric in spec.end_to_end(name):
            metrics[metric["name"]] = {"value": values[metric["name"]],
                                       "unit": metric["unit"]}
    ctx.mark(f"metrics {json.dumps(metrics)}")
    driver.release()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    checks = driver.check()
    ctx.mark("checked")
    line = {
        "correct": checks_mod.correct(checks),
        "attempted": driver.attempted,
        "failed": driver.failed,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if on_card else "cpu",
            "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
            "count": cell["chips"],
            "memory_peak_bytes": memory_peak,
        },
    }
    if on_card:
        line["device"]["power_limit_w"] = env.power_limit_w()
    if trace:
        line["device"]["busy_s"] = summary.busy_s
        line["device"]["window_s"] = summary.window_s
        line["breakdown"] = summary.breakdown()
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                      for c in checks}
    return line


def main(started: float, argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    env.prepare(ROOT)
    if not env.program_present(ROOT):
        print(f"portbench: the program {env.PROGRAM} is not in {ROOT}",
              file=sys.stderr)
        return 2
    spec = spec_mod.load(ROOT)
    chips = spec.entry("workloads", args.workload)["chips"]
    try:
        env.require_cards(chips)
    except env.NoCard as err:
        print(f"portbench: {err}", file=sys.stderr)
        return 3
    line = run_cell(spec, args.workload, args.seed, args.seconds,
                    bool(args.trace), "cuda", started)
    banned = env.banned_modules()
    if banned:
        print(f"portbench: modules of JAX or the JAX package are loaded: "
              f"{', '.join(banned)}", file=sys.stderr)
        return 4
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0
