"""The benchmark's general harness: one run of one cell.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

A cell is an entry of `workloads` in `BENCHMARK.json`: a configuration
(`configs[].file`, a JSON file of sizes) under a traffic mix
(`benchmark/traffic/<traffic>.json`, a JSON file of parameters). The traffic
names its `kind`, the general code in `benchmark/kinds/<kind>.py` that
reads it; the cell's correctness limits are `benchmark/limits/<workload>.json`
and each per-layer metric is read by `benchmark/metrics/<metric>.py`. All of
them are found by name, so a new cell, configuration or metric is new files
and entries only.

A run: set-up (the kind's `setup`, which builds the program's objects from
the seed, drives its first steps and warms every shape the window uses),
then the window of `--seconds` (the kind's `step`, again and again, closed
loop), then with `--trace 1` a traced sub-window and the kind's probes, then
the check of the outputs against the plain reference once the program's
state is freed. The last line of standard output is the result.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import itertools
import json
import math
import os
import statistics
import sys
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "raptor_tpu")  # top-level module names


def derive_seed(seed: int, *tags) -> int:
    """A 63-bit seed for one use, fixed by the run's seed and the tags."""
    h = hashlib.sha256(repr((int(seed),) + tags).encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def load_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """benchmark/<kind>/<name>.py as a module of its own."""
    path = os.path.join(HERE, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"bench_{kind}_{name}".replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def forbidden_modules(names=None) -> List[str]:
    """Loaded modules (or `names`) whose top-level name is JAX's or the JAX
    package's, compared whole (the part before the first dot)."""
    names = list(sys.modules) if names is None else names
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN})


@dataclass
class Cell:
    """What a run knows of its cell."""

    workload: str
    config: dict
    traffic: dict
    limits: Optional[dict]
    end_to_end: List[dict]
    per_layer: List[dict]
    chips: int


def find_cell(workload: str, spec: Optional[dict] = None, root: str = ROOT) -> Cell:
    spec = spec if spec is not None else load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[workload]
    config_file = {c["name"]: c["file"] for c in spec["configs"]}[w["config"]]
    limits_path = os.path.join(HERE, "limits", f"{workload}.json")
    e2e = [m for m in spec["end_to_end"] if workload in m.get("workloads", [workload])]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if workload in m.get("workloads", [workload] if m["moves"] in reported else [])]
    return Cell(
        workload=workload,
        config=load_json(os.path.join(root, config_file)),
        traffic=load_json(os.path.join(HERE, "traffic", f"{w['traffic']}.json")),
        limits=load_json(limits_path) if os.path.exists(limits_path) else None,
        end_to_end=e2e, per_layer=per_layer, chips=w["chips"],
    )


@dataclass
class Context:
    """Handed to a kind's set-up and to the per-layer readers."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: Any
    window: Dict[str, Any] = field(default_factory=dict)
    device_trace: Any = None
    stats: Dict[str, Any] = field(default_factory=dict)  # what a kind measured for the readers


def use_checkout_caches() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths (set
    before torch is imported), and no JAX loaded by a library."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = os.path.join(ROOT, "build", "bench_cache", sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def run_window(run, seconds: float) -> Dict[str, Any]:
    """Closed loop: `run.step(i)` again and again until `seconds` have passed
    on the host's clock, then `run.sync()`. The span runs from the window's
    start to the end of its last step."""
    latencies, units = [], 0.0
    t0 = time.perf_counter()
    i = 0
    while time.perf_counter() - t0 < seconds:
        ts = time.perf_counter()
        units += run.step(i)
        latencies.append(time.perf_counter() - ts)
        i += 1
    run.sync()
    span = time.perf_counter() - t0
    return {"steps": i, "units": units, "span": span, "latencies": latencies}


def end_to_end_metrics(ctx: Context, run, setup_s: float) -> Dict[str, dict]:
    names = ctx.cell.traffic["metrics"]
    w = ctx.window
    values = {"setup_s": setup_s}
    if "rate" in names:
        values[names["rate"]] = w["units"] / w["span"]
    if "latency_p95" in names:
        if not run.synchronous:
            raise ValueError("a latency needs steps that end with their result on the host")
        p95 = statistics.quantiles(w["latencies"], n=20, method="inclusive")[18]
        values[names["latency_p95"]] = 1000.0 * p95
    out = {}
    for m in ctx.cell.end_to_end:
        if m["name"] not in values:
            raise KeyError(f"cell {ctx.cell.workload} reports no {m['name']}")
        out[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    return out


def per_layer_metrics(ctx: Context) -> Dict[str, dict]:
    out = {}
    for m in ctx.cell.per_layer:
        value = load_module("metrics", m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def judge(numbers: Dict[str, float], limits: Optional[dict]) -> tuple:
    """(correct, {name: {value, limit}}): every number at or under its limit;
    a number without a limit, or a limit without its number, is not correct."""
    table = (limits or {}).get("limits", {})
    checks, ok = {}, bool(table)
    for name in sorted(set(numbers) | set(table)):
        value = numbers.get(name)
        limit = table.get(name, {}).get("limit")
        finite = value is not None and math.isfinite(value)
        checks[name] = {"value": value if finite or value is None else repr(value), "limit": limit}
        ok = ok and finite and limit is not None and value <= limit
    return ok, checks


def run_cell(ctx: Context, t_start: Optional[float] = None) -> dict:
    """One run of the cell on ctx.device; returns the result line's dict.
    `setup_s` counts from `t_start` (the process's start where given)."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    run = load_module("kinds", ctx.cell.traffic["kind"]).setup(ctx)
    run.sync()
    setup_s = time.perf_counter() - t_start
    ctx.window = run_window(run, ctx.seconds)
    if ctx.trace:
        from tracing import DeviceTrace

        with DeviceTrace(ctx.device) as tr:
            for i in range(ctx.cell.traffic["trace_steps"]):
                run.step(ctx.window["steps"] + i, traced=True)
            run.sync()
        ctx.device_trace = tr
        run.probe()
    attempted, failed = ctx.window["steps"], run.failed()
    peak = torch.cuda.max_memory_allocated(ctx.device) if ctx.device.type == "cuda" else 0
    if ctx.trace:
        metrics = per_layer_metrics(ctx)
    else:
        metrics = end_to_end_metrics(ctx, run, setup_s)
    numbers = run.check()  # frees the program's state, then the reference runs
    correct, checks = judge(numbers, ctx.cell.limits)
    device = {"platform": "gpu" if ctx.device.type == "cuda" else ctx.device.type,
              "kind": torch.cuda.get_device_name(ctx.device) if ctx.device.type == "cuda"
              else "cpu", "count": ctx.cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct and failed == 0), "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device}
    if ctx.trace:
        tr = ctx.device_trace
        device.update(busy_s=tr.busy_s(), window_s=tr.window_s)
        result["breakdown"] = {"device_ops": tr.top_device_ops(), "idle_gaps": tr.idle_gaps()}
    result["checks"] = checks
    return result


def main(argv=None, t_start: Optional[float] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    if not os.path.isdir(os.path.join(ROOT, "raptor_tpu_torch")):
        print("the system under test (raptor_tpu_torch/) is not in this checkout", file=sys.stderr)
        return 2
    cell = find_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    # the configurations state float32 with TF32 off
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(1)
    ctx = Context(cell=cell, seed=args.seed % 2**63, seconds=args.seconds,
                  trace=bool(args.trace), device=torch.device("cuda", 0))
    result = run_cell(ctx, t_start)
    w = ctx.window
    if w["steps"] and not ctx.trace:  # the window in fifths, a diagnostic of drift within it
        fifths = [0] * 5
        for end in itertools.accumulate(w["latencies"]):
            fifths[min(4, int(5 * end / w["span"]))] += 1
        print(f"window steps by fifth: {fifths} span {w['span']:.3f} s", file=sys.stderr)
    bad = forbidden_modules()
    if bad:
        print(f"loaded modules of JAX or the JAX package: {bad}", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(result, allow_nan=False), flush=True)
    return 0
