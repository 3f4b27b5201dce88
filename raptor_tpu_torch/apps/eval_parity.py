"""CLI: sweep the initial-attitude bound of the evaluation and score a policy
at each angle, on the held-out crazyflie and on random airframes.

Counterpart of `raptor_tpu/apps/eval_parity.py`. The sweep pins the evaluation
protocol down: the largest `max_angle` at which the shipped reference policy
reproduces its own logged evaluation (about 480 of 500 steps, 4-5 %
terminated) defines `env.types.eval_parity_init()`. The shipped policy's rows
are printed only where `$RAPTOR_REFERENCE_DIR` names a checkout that holds it;
a student (`--checkpoint`, `.h5` or `.npz`) is scored on its own otherwise.

    python -m raptor_tpu_torch.apps.eval_parity --checkpoint raptor_tpu_torch/data/student_rateFlagCurMix.npz --fused
    python -m raptor_tpu_torch.apps.eval_parity --checkpoint ckpt.h5 --angles 0.5,1.0 --device cpu

`--fused` runs each evaluation in the eval kernel (`ops/eval.py`), as
`apps/evaluate.py --fused` does; without it the eager loop of
`rl/evaluation.py` runs.
"""

from __future__ import annotations

import argparse
import json
from typing import Optional

import torch

from raptor_tpu_torch.checkpoint import from_numpy, h5
from raptor_tpu_torch.device import resolve_device
from raptor_tpu_torch.env import EnvConfig, InitConfig, L2F, presets
from raptor_tpu_torch.env.randomization import sample_population
from raptor_tpu_torch.env.types import DynamicsParams, State, tree_map
from raptor_tpu_torch.ops import eval as ops_eval
from raptor_tpu_torch.policy.raptor import shipped_checkpoint_path
from raptor_tpu_torch.rl import evaluation

REFERENCE_TARGETS = {
    "aggregate": {"episode_length": 482.8, "share_terminated": 0.042},
    "crazyflie": {"episode_length": 477.4, "share_terminated": 0.050},
}


def evaluate_at_angle(
    policy_params,
    angle: float,
    generator: torch.Generator,
    n_airframes: int,
    envs_per: int,
    airframe: str = "random",
    fused: bool = False,
    stacked: Optional[DynamicsParams] = None,
    state: Optional[State] = None,
) -> evaluation.EvalStats:
    """5-stat evaluation of a recurrent policy with initial attitudes up to
    `angle`, on the generator's device. `stacked` ([n_airframes * envs_per]
    airframes) and `state` (their initial states) replace the draws from the
    generator where given."""
    device = generator.device
    m = n_airframes * envs_per
    env = L2F(EnvConfig(init=InitConfig(max_angle=angle)))
    if stacked is None:
        if airframe == "random":
            frames = sample_population(generator, n_airframes)
            stacked = tree_map(lambda x: x.repeat_interleave(envs_per, 0), frames)
        else:
            one = getattr(presets, airframe)(device)
            stacked = tree_map(lambda x: x.expand(m, *x.shape[1:]).contiguous(), one)
    if state is None:
        state = env.reset(stacked, generator)[0].dynamics
    with torch.no_grad():
        if fused:
            term = env.config.termination
            _, alive, length, ret = ops_eval.fused_policy_eval(
                policy_params, stacked, state, env.EPISODE_LENGTH, dt=env.config.dt,
                pos_bound=term.position_bound, angvel_bound=term.angular_velocity_bound,
                reward_config=env.config.reward, linvel_bound=term.linear_velocity_bound,
                device=device,
            )
            return evaluation.summarize(ret, length, alive)
        step_fn, carry = evaluation.gru_policy_step(policy_params, m)
        return evaluation.evaluate_from(env, stacked, state, step_fn, carry, generator)


def _row(stats: evaluation.EvalStats) -> dict:
    return {
        "episode_length": float(stats.episode_length_mean),
        "share_terminated": float(stats.share_terminated),
        "return": float(stats.return_mean),
    }


def _print_row(label, cf, ag):
    print(f"{label:>7} | {cf['episode_length']:7.1f} {cf['share_terminated']:8.3f} "
          f"{cf['return']:8.1f} | {ag['episode_length']:7.1f} {ag['share_terminated']:8.3f} "
          f"{ag['return']:8.1f}")


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--checkpoint", default=None,
                   help="score this student (.h5 or .npz) at each angle")
    p.add_argument("--angles", default="0.2,0.4,0.6,0.8,1.0,1.2,1.5,2.0,3.14159",
                   help="comma-separated max_angle sweep (rad)")
    p.add_argument("--n-airframes", type=int, default=32)
    p.add_argument("--envs-per-airframe", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None, help="write JSON report here")
    p.add_argument("--fused", action="store_true",
                   help="use the fused policy+env eval kernel")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    try:
        shipped = from_numpy(h5.load_actor(shipped_checkpoint_path()), device)
    except FileNotFoundError:
        shipped = None
    student = from_numpy(h5.load_actor(args.checkpoint), device) if args.checkpoint else None
    if shipped is None and student is None:
        p.error("no shipped checkpoint ($RAPTOR_REFERENCE_DIR unset): pass --checkpoint")

    def score(policy, angle, stream, airframe):
        # one generator per (policy, airframe) stream, the same at every angle
        gen = torch.Generator(device=device).manual_seed(args.seed * 8 + stream)
        return _row(evaluate_at_angle(
            policy, angle, gen, args.n_airframes, args.envs_per_airframe, airframe, args.fused))

    angles = [float(a) for a in args.angles.split(",")]
    report = {"reference_targets": REFERENCE_TARGETS, "device": str(device),
              "fused": args.fused, "sweep": []}
    header = (f"{'angle':>7} | {'cf len':>7} {'cf term':>8} {'cf ret':>8} | "
              f"{'agg len':>7} {'agg term':>8} {'agg ret':>8}")
    print(header)
    print("-" * len(header))
    for a in angles:
        row = {"max_angle": a}
        if shipped is not None:
            row["crazyflie"] = score(shipped, a, 1, "crazyflie")
            row["aggregate"] = score(shipped, a, 2, "random")
            _print_row(f"{a:.3f}", row["crazyflie"], row["aggregate"])
        if student is not None:
            row["student_crazyflie"] = score(student, a, 3, "crazyflie")
            row["student_aggregate"] = score(student, a, 4, "random")
            _print_row("stud." if shipped is not None else f"{a:.3f}",
                       row["student_crazyflie"], row["student_aggregate"])
        report["sweep"].append(row)

    # the largest angle at which the shipped policy's aggregate still matches
    # its own logged final evaluation: length >= 480 and termination <= 5.5 %
    best = None
    for row in report["sweep"]:
        ag = row.get("aggregate")
        if ag and ag["episode_length"] >= 480.0 and ag["share_terminated"] <= 0.055:
            if best is None or row["max_angle"] > best:
                best = row["max_angle"]
    report["eval_parity_max_angle"] = best
    if shipped is not None:
        print(f"\neval-parity max_angle (largest matching reference envelope): {best}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
        print(f"report: {args.out}")
    return report


if __name__ == "__main__":
    main()
