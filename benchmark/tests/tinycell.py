"""Cells of the benchmark cut to a size a CPU test holds: the same harness,
kinds, references and limits, with the sizes of the configuration and the
traffic made small."""

from __future__ import annotations

import copy
import glob
import os
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for path in (ROOT, BENCH):
    if path not in sys.path:
        sys.path.insert(0, path)

import torch  # noqa: E402

import core  # noqa: E402

TINY_CONFIG = {
    "distill_config": dict(rollout_length=24, aggregate_capacity=48, batch_size=8),
    "eval": dict(n_airframes=6, envs_per_airframe=2, episode_length=40),
    "population": dict(n_teachers=3, envs_per_teacher=4, rollout_length=3, gradient_steps=2,
                       batch_size=8, replay_capacity=16, warmup_super_steps=2),
}
TINY_TRAFFIC = dict(check_range=3, trace_steps=2, probe_requests=2, steps_per_call=2)


def tiny(cell: core.Cell) -> core.Cell:
    cell.config = copy.deepcopy(cell.config)
    for group, sizes in TINY_CONFIG.items():
        if group in cell.config:
            cell.config[group].update(sizes)
    cell.traffic = dict(cell.traffic, **{k: v for k, v in TINY_TRAFFIC.items()
                                         if k in cell.traffic})
    return cell


def spec(root: str = ROOT) -> dict:
    """BENCHMARK.json with the entries of the cells prepared under
    benchmark/pending/ added."""
    out = core.load_json(os.path.join(root, "BENCHMARK.json"))
    for path in sorted(glob.glob(os.path.join(root, "benchmark", "pending", "*.json"))):
        pending = core.load_json(path)
        for key in ("configs", "workloads", "end_to_end", "per_layer"):
            out[key] = out[key] + pending[key]
    return out


def cell(workload: str, root: str = ROOT) -> core.Cell:
    """A committed or a pending cell at its own size."""
    return core.find_cell(workload, spec(root), root)


def context(workload: str, seed: int = 2**31 + 11, seconds: float = 0.5, trace: bool = False,
            root: str = ROOT) -> core.Context:
    cell_ = tiny(cell(workload, root))
    return core.Context(cell=cell_, seed=seed, seconds=seconds, trace=trace,
                        device=torch.device("cpu"))


def run(workload: str, **kw) -> dict:
    return core.run_cell(context(workload, **kw))
