"""The control of each cell's check, at the cell's own size.

    python3 portbench/control.py --workload NAME --seeds 11 12 13 [--calls N]

The control is the plain reference put in the program's place and
computed in the nearest precision below the configuration's (its file's
`control`: 'bfloat16' for the LGSSM's float32), on the
cell's inputs from each seed. It prints one JSON line a seed and
precision with the numbers the cell compares, each beside the cell's
limit, and `correct` as a run of the cell would judge them
(`checks.checks`, `checks.correct`): the control has to come out false.
Beside it the same reference at the configuration's precision ('sound')
is a second witness of what a sound run reads. A cell's limit lies
between what sound runs of the program read and what the control reads.
The benchmark's runs never run this.
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import argparse  # noqa: E402
import json  # noqa: E402

from portbench.harness import (  # noqa: E402
    checks, env, runner, spec as spec_mod)


def _dtype(name):
    import torch
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


def _filter(ctx, precision, calls):
    import torch
    from portbench.reference.draws import FreshDraws
    traffic, ref = ctx.traffic, ctx.reference
    t, b, k = (traffic[n] for n in ("num_timesteps", "batch_size",
                                    "num_particles"))
    model = ref.model_params(ctx.config)
    obs = ctx.model.observations(ctx.config["model"], ctx.generator(1), t, b)
    exact = ref.exact_log_z(obs.double().cpu().numpy(), model)
    params = dict(ctx.model.proposal_params(model), **model)
    dtype = _dtype(precision)
    draws = FreshDraws(ctx.generator(2), dtype)
    with torch.no_grad():
        est = [ref.filter_log_z(model, params, obs.to(dtype), k,
                                draws).double().cpu().numpy()
               for _ in range(calls)]
    return {"logz_gap": checks.widest_gap(est, exact[None, :])}


def _serve(ctx, precision, calls):
    import torch
    from portbench.reference.draws import FreshDraws
    traffic, ref = ctx.traffic, ctx.reference
    b, k = traffic["batch_size"], traffic["num_particles"]
    model = ref.model_params(ctx.config)
    obs = ctx.model.observations(ctx.config["model"], ctx.generator(1),
                                 calls + 1, b)
    exact = ref.exact_terms(obs.double().cpu().numpy(), model)
    params = dict(ctx.model.proposal_params(model), **model)
    dtype = _dtype(precision)
    with torch.no_grad():
        preds = ref.stream(model, params, obs.to(dtype), k,
                           FreshDraws(ctx.generator(2), dtype))
    preds = torch.cat([torch.full_like(preds[:1], float("nan")), preds])
    picked = 1 + checks.sample(calls, ctx.check["sample"], ctx.seed)
    return {"pred_gap": checks.widest_gap(
        preds.double().cpu().numpy()[picked], exact[picked])}


KINDS = {"infer_graph": _filter, "serve_closed_loop": _serve}


def control(spec, name, seed, device, precision=None, calls=64,
            overrides=None):
    """The checks of cell ``name`` (`checks.Check`s at the cell's limits)
    with the reference in the program's place at ``precision`` (default:
    the configuration's control)."""
    cell = runner._merge(spec.cell(name), overrides or {})
    ctx = runner.Context(root=spec.root, name=name, seed=seed, device=device,
                         config=cell["config_data"], traffic=cell["traffic"],
                         check=cell["check"], trace=cell["trace"])
    precision = precision or ctx.config["control"]
    numbers = KINDS[cell["driver"]](ctx, precision, calls)
    return checks.checks(numbers, ctx.check["limits"])


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--calls", type=int, default=64,
                        help="filter calls, or served observations")
    args = parser.parse_args(argv)
    root = pathlib.Path(__file__).resolve().parents[1]
    env.prepare(root)
    import torch
    env.require_cards(1)
    env.float32_means_float32()
    spec = spec_mod.load(root)
    for seed in args.seeds:
        for precision in (None, "float32"):
            found = control(spec, args.workload, seed, "cuda", precision,
                            args.calls)
            print(json.dumps({
                "workload": args.workload, "seed": seed,
                "precision": precision or "control",
                "correct": checks.correct(found),
                "checks": {c.name: {"value": c.value, "limit": c.limit}
                           for c in found}}), flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
