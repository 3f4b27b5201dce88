"""Per-airframe termination of a student from near-hover starts, with the
airframe's physics beside it (counterpart of `tools/hover_tail_probe.py`):

    python -m raptor_tpu_torch.tools.hover_tail_probe raptor_tpu_torch/data/student_rateFlagCurPure.npz \\
        --angle 0.2 [--n-airframes 32 --envs-per 8] [--device cpu] [--out report.json]

`--n-airframes` random airframes, each flown from `--envs-per` initial
states drawn at `--angle` (rad) for one episode (500 steps), through eval
kernel B2 (`ops.eval.make_fused_policy_eval`, which gives alive and length
per env; its plain version on the CPU) with the env's termination bounds. The
report is JAX's: for each airframe its thrust-to-weight ratio, motor time
constant and mass, and for each checkpoint the share of its envs that
terminated and their mean episode length; the total share of each checkpoint
is printed. The airframes and states come from the port's generators, so a
report agrees with the JAX one in distribution, not row by row.

B2 integrates deterministic dynamics: airframes with a nonzero disturbance
std, which JAX's eager loop would draw, raise ValueError (the randomization's
default is 0). Prints the table; writes the report only where `--out` names
a file.
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from raptor_tpu_torch.device import resolve_device


def per_airframe_eval(policy, params, state, n_airframes: int, envs_per: int, config, device):
    """alive [A, E] and length [A, E] of one episode of `config.episode_length`
    steps from `state` [A * E] on airframes `params` [A * E], through B2."""
    from raptor_tpu_torch.env.types import tree_map
    from raptor_tpu_torch.ops.eval import make_fused_policy_eval

    dev = resolve_device(device)
    params, state = (tree_map(lambda x: x.to(dev), t) for t in (params, state))
    noise = torch.maximum(params.disturbance_force_std.abs().max(),
                          params.disturbance_torque_std.abs().max())
    if float(noise) > 0.0:
        raise ValueError("eval kernel B2 flies deterministic dynamics: these airframes carry "
                         "a nonzero disturbance std")
    term = config.termination
    run = make_fused_policy_eval(
        {layer: {k: v.to(dev) for k, v in t.items()} for layer, t in policy.items()},
        config.episode_length, config.dt, term.position_bound, term.angular_velocity_bound,
        config.reward, term.linear_velocity_bound, dev)
    _, alive, length, _ = run(params, state)
    return alive.reshape(n_airframes, envs_per), length.reshape(n_airframes, envs_per)


def fly(checkpoints, config, n_airframes: int, envs_per: int, seed: int, device):
    """`n_airframes` airframes drawn from `seed`, each with `envs_per` initial
    states at `config`'s init, and every checkpoint flown from them through
    B2 (`per_airframe_eval`): (airframes [A], their envs' airframes [A * E],
    initial states [A * E], {checkpoint: (alive [A, E], length [A, E])})."""
    from raptor_tpu_torch.checkpoint import from_numpy, h5
    from raptor_tpu_torch.env import L2F, sample_population
    from raptor_tpu_torch.env.types import tree_map

    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    frames = sample_population(gen, n_airframes)
    stacked = tree_map(lambda x: x.repeat_interleave(envs_per, 0), frames)
    state = L2F(config).sample_state(stacked, gen)
    flights = {ck: per_airframe_eval(from_numpy(h5.load_actor(ck), dev), stacked, state,
                                     n_airframes, envs_per, config, dev)
               for ck in checkpoints}
    return frames, stacked, state, flights


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("checkpoints", nargs="+", help="student checkpoints (.h5 or .npz)")
    p.add_argument("--angle", type=float, default=0.2)
    p.add_argument("--n-airframes", type=int, default=32)
    p.add_argument("--envs-per", type=int, default=8)
    p.add_argument("--episode-length", type=int, default=500)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=None, help="JSON report path")
    args = p.parse_args(argv)

    from raptor_tpu_torch.env import EnvConfig, InitConfig

    config = EnvConfig(init=InitConfig(max_angle=args.angle), episode_length=args.episode_length)
    frames, _, _, flights = fly(args.checkpoints, config, args.n_airframes, args.envs_per,
                                args.seed, args.device)
    twr = (4 * frames.thrust_curve.sum(1) / (frames.mass * 9.81)).tolist()
    tau, mass = frames.motor_time_constant.tolist(), frames.mass.tolist()
    results = {ck: ((1.0 - alive).mean(1).tolist(), length.float().mean(1).tolist())
               for ck, (alive, length) in flights.items()}

    tags = [os.path.basename(c) for c in args.checkpoints]
    report = {"angle": args.angle, "per_airframe": []}
    print(f"angle={args.angle}  per-airframe share_terminated")
    print(f"{'frame':>5} {'TWR':>6} {'tau':>6} {'mass':>6} | "
          + " ".join(f"{t[:18]:>18}" for t in tags))
    for i in range(args.n_airframes):
        terms = [results[c][0][i] for c in args.checkpoints]
        report["per_airframe"].append({
            "frame": i, "twr": twr[i], "tau": tau[i], "mass": mass[i],
            **{t: {"share_terminated": results[c][0][i], "episode_length": results[c][1][i]}
               for t, c in zip(tags, args.checkpoints)},
        })
        if any(t > 0 for t in terms):
            print(f"{i:>5} {twr[i]:>6.2f} {tau[i]:>6.3f} {mass[i]:>6.3f} | "
                  + " ".join(f"{t:>18.2f}" for t in terms))
    for t, c in zip(tags, args.checkpoints):
        print(f"total {t}: {sum(results[c][0]) / args.n_airframes:.4f}")
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(report, fh, indent=1)
        print("wrote", args.out)
    return report


if __name__ == "__main__":
    main()
