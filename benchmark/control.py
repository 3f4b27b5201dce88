"""Readings that the correctness limits are set from, at a cell's own size:
for each seed, the cell's set-up and a short window, then the check's
numbers for the program and for the control (the plain reference computed
in TF32, put in the program's place), or with `--fault` for the program with
that fault planted (`faults.py`). The benchmark's own runs never run this.

    python3 benchmark/control.py --workload distill_train --seeds 11,12,13 \
        [--fault half_batch] [--seconds 2] [--out readings.jsonl]

One JSON line a seed: {"seed", "fault", "program": {...}, "tf32": {...}}.
"""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import time  # noqa: E402

import core  # noqa: E402
import faults  # noqa: E402


def readings(cell, seed, seconds, device, fault=None, which=("program", "tf32")):
    """The check's numbers of one seed."""
    import torch

    ctx = core.Context(cell=cell, seed=seed, seconds=seconds, trace=False, device=device)
    plant = faults.planted(cell.traffic["kind"], fault) if fault else contextlib.nullcontext()
    t0 = time.perf_counter()
    with plant:
        run = core.load_module("kinds", cell.traffic["kind"]).setup(ctx)
        ctx.window = core.run_window(run, seconds)
        out = run.check(which=which)
    if which == ("program",):
        out = {"program": out}
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return {"seed": seed, "fault": fault, "steps": ctx.window["steps"],
            "seconds": time.perf_counter() - t0, **out}


def main(argv=None):
    core.use_checkout_caches()
    import torch

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--fault", default=None)
    p.add_argument("--no-control", action="store_true", help="read the program only")
    p.add_argument("--out", default=None, help="append the lines to this file too")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("control readings are taken on a CUDA card", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = core.find_cell(args.workload)
    if cell.traffic["kind"] == "eval":  # the checked requests fall inside the short window
        cell.traffic = dict(cell.traffic, check_range=cell.traffic["check_requests"] * 2)
    which = ("program",) if args.no_control or args.fault else ("program", "tf32")
    for seed in (int(s) for s in args.seeds.split(",")):
        line = json.dumps(readings(cell, seed, args.seconds, torch.device("cuda", 0),
                                   args.fault, which))
        print(line, flush=True)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
