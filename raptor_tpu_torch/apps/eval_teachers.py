"""Evaluate a teacher pack or manifest: per-teacher deterministic eval on
its own airframe, aggregate stats as JSON.

Counterpart of `raptor_tpu/apps/eval_teachers.py`, with the same flags plus
`--device`, and the same report: one entry per pack, keyed by the path as
given, with the same keys in the same order. The hover gate of the recipe
runs it at `--episodes 4 --max-angle 0.2` and feeds the report to
`apps/filter_teachers.py`:

    python -m raptor_tpu_torch.apps.eval_teachers PACK_OR_MANIFEST [...] \
        --episodes 8 --out report.json

All K teachers of a pack fly at once (`distill.population.make_population_eval`),
`--episodes` envs each, for the env's episode length.
"""

from __future__ import annotations

import argparse
import json
import types
from typing import Optional

import numpy as np
import torch

from raptor_tpu_torch.device import resolve_device
from raptor_tpu_torch.distill.population import make_population_eval
from raptor_tpu_torch.env import EnvConfig, InitConfig, L2F
from raptor_tpu_torch.env.types import DynamicsParams, State


def evaluate_pack(env: L2F, actors, airframes: DynamicsParams, episodes: int,
                  generator: torch.Generator, state: Optional[State] = None) -> dict:
    """The report entry of one pack: stacked [K] actors on their own [K]
    airframes, `episodes` envs each. `state` ([K * episodes] initial
    states, teacher-major) replaces the draws from the generator where
    given."""
    k = airframes.mass.shape[0]
    stats = make_population_eval(env, episodes, env.EPISODE_LENGTH)(
        types.SimpleNamespace(actor=actors), airframes, generator, state=state)
    ret = stats.return_mean.cpu().numpy()
    length = stats.episode_length_mean.cpu().numpy()
    term = stats.share_terminated.cpu().numpy()
    return {
        "teachers": int(k),
        "episodes_per_teacher": episodes,
        "return/mean": float(ret.mean()),
        "return/std_across_teachers": float(ret.std()),
        "return/p10": float(np.percentile(ret, 10)),
        "return/p50": float(np.percentile(ret, 50)),
        "return/p90": float(np.percentile(ret, 90)),
        "episode_length/mean": float(length.mean()),
        "share_terminated/mean": float(term.mean()),
        "per_teacher_return": [float(x) for x in ret],
        "per_teacher_share_terminated": [float(x) for x in term],
    }


def main(argv=None):
    from raptor_tpu_torch.apps.post_training import load_teachers

    p = argparse.ArgumentParser()
    p.add_argument("packs", nargs="+", help="teacher pack .npz / checkpoints.txt manifests")
    p.add_argument("--episodes", type=int, default=8, help="eval episodes per teacher")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max-angle", type=float, default=None,
                   help="override the init max_angle (rad); e.g. 0.2 probes hover "
                        "competence of each teacher on its own airframe")
    p.add_argument("--out", default=None, help="JSON report path")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    init = InitConfig() if args.max_angle is None else InitConfig(max_angle=args.max_angle)
    env = L2F(EnvConfig(init=init))

    report = {}
    for path in args.packs:
        actors, airframes = load_teachers(path, device)
        generator = torch.Generator(device=device).manual_seed(args.seed)
        report[path] = evaluate_pack(env, actors, airframes, args.episodes, generator)
        print(json.dumps({path: {kk: vv for kk, vv in report[path].items()
                                 if kk != "per_teacher_return"}}), flush=True)

    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return report


if __name__ == "__main__":
    main()
