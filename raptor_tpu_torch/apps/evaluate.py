"""CLI: evaluate a policy checkpoint across the airframe distribution and
print the 5-stat JSON.

Counterpart of `raptor_tpu/apps/evaluate.py`, with the same flags plus
`--device` and `--eval-parity-init` (initial attitudes up to 1 rad, the
distribution the committed students' eval-parity numbers were taken at):

    python -m raptor_tpu_torch.apps.evaluate raptor_tpu_torch/data/student_rateFlagCurMix.npz --fused
    python -m raptor_tpu_torch.apps.evaluate ckpt.h5 --airframe crazyflie --device cpu

`--fused` runs the whole closed loop in the eval kernel (`ops/eval.py`);
without it the eager loop of `rl/evaluation.py` runs.
"""

from __future__ import annotations

import argparse
import json

import torch

from raptor_tpu_torch.checkpoint import from_numpy, h5
from raptor_tpu_torch.device import resolve_device
from raptor_tpu_torch.env import EnvConfig, InitConfig, L2F, eval_parity_init, presets
from raptor_tpu_torch.env.randomization import sample_population
from raptor_tpu_torch.env.types import tree_map
from raptor_tpu_torch.ops import eval as ops_eval
from raptor_tpu_torch.policy.raptor import shipped_checkpoint_path
from raptor_tpu_torch.rl import evaluation


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("checkpoint", nargs="?", help="policy checkpoint, .h5 or .npz")
    p.add_argument("--shipped", action="store_true",
                   help="evaluate the shipped reference checkpoint")
    p.add_argument("--airframe", choices=["random", "crazyflie", "x500"],
                   default="random")
    p.add_argument("--n-airframes", type=int, default=32)
    p.add_argument("--envs-per-airframe", type=int, default=8)
    p.add_argument("--episode-length", type=int, default=0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--fused", action="store_true",
                   help="use the fused policy+env eval kernel")
    p.add_argument("--eval-parity-init", action="store_true",
                   help="initial attitudes up to 1 rad instead of pi")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    if args.shipped or not args.checkpoint:
        args.checkpoint = shipped_checkpoint_path()
    policy = from_numpy(h5.load_actor(args.checkpoint), device)

    env = L2F(EnvConfig(init=eval_parity_init() if args.eval_parity_init else InitConfig()))
    if args.airframe == "random":
        gen = torch.Generator(device=device).manual_seed(args.seed)
        frames = sample_population(gen, args.n_airframes)
    else:
        frames = getattr(presets, args.airframe)(device)
    stacked = tree_map(lambda x: x.repeat_interleave(args.envs_per_airframe, 0), frames)
    m = stacked.mass.shape[0]
    t_max = args.episode_length or env.EPISODE_LENGTH
    gen = torch.Generator(device=device).manual_seed(args.seed + 1)
    out = {"checkpoint": args.checkpoint, "airframe": args.airframe, "episodes": m}
    if args.fused:
        es, _ = env.reset(stacked, gen)
        term = env.config.termination
        _, alive, length, ret = ops_eval.fused_policy_eval(
            policy, stacked, es.dynamics, t_max, dt=env.config.dt,
            pos_bound=term.position_bound, angvel_bound=term.angular_velocity_bound,
            reward_config=env.config.reward, linvel_bound=term.linear_velocity_bound,
            device=device,
        )
        out["kernel"] = "fused"
        s = evaluation.summarize(ret, length, alive)
    else:
        step_fn, carry = evaluation.gru_policy_step(policy, m)
        s = evaluation.evaluate(env, stacked, step_fn, carry, gen, m, t_max)
    out.update(
        {
            "return/mean": float(s.return_mean),
            "return/std": float(s.return_std),
            "episode_length/mean": float(s.episode_length_mean),
            "episode_length/std": float(s.episode_length_std),
            "share_terminated": float(s.share_terminated),
        }
    )
    print(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()
