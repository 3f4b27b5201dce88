"""Scripted full-attitude recovery: is the pi-start gap learnable headroom?

Counterpart of `raptor_tpu/apps/scripted_recovery.py`, with the same flags
plus `--device` and the same report. A scripted geometric controller
(privileged state, no learning; `env/recovery.py`) flies the
flip-arrest-hover sequence under the full standard dynamics (motor lag,
thrust curves, randomized airframes) and the standard termination. Where it
survives pi starts that learned policies do not, the gap is learnable.

    python -m raptor_tpu_torch.apps.scripted_recovery --out scripted_recovery.json
    python -m raptor_tpu_torch.apps.scripted_recovery --grid '1:0.8:1.5;1:0.6:1.0'

`--adaptive` caps (w_cap, k_w) per airframe (`env.recovery.adaptive_gain_caps`);
`--grid` sweeps adaptive (c_flip, c_lag, c_bw) configurations one after the
other from the same seed.
"""

from __future__ import annotations

import argparse
import json
from typing import Optional

import numpy as np
import torch

from raptor_tpu_torch.apps.failure_modes import probe_airframes, termination_causes
from raptor_tpu_torch.device import resolve_device
from raptor_tpu_torch.env import EnvConfig, InitConfig, L2F
from raptor_tpu_torch.env.recovery import recovery_action as controller
from raptor_tpu_torch.env.types import DynamicsParams, State, where


@torch.no_grad()
def rollout(env: L2F, params: DynamicsParams, generator: torch.Generator, m: int,
            state: Optional[State] = None, steps: Optional[int] = None, **gains):
    """One episode of the scripted controller on `m` envs from fresh states
    (or from `state` where given): the (alive, snapshot) contract of
    `apps.failure_modes.probe`, with the step and the position and rate
    causes. `steps` cuts the episode."""
    if state is None:
        state = env.reset(params, generator)[0].dynamics
    dev = params.mass.device
    alive = torch.ones(m, device=dev)
    snap = {
        "t": torch.full((m,), -1, dtype=torch.int32, device=dev),
        "pos_hit": torch.zeros(m, dtype=torch.bool, device=dev),
        "w_hit": torch.zeros(m, dtype=torch.bool, device=dev),
    }
    for t in range(steps or env.EPISODE_LENGTH):
        action = controller(params, state, **gains)
        stepped, _ = env.dynamics_step(params, state, action, generator)
        next_state = where(alive > 0.5, stepped, state)
        terminated = env.terminated(params, next_state)
        new_term = (alive > 0.5) & terminated
        now = {**termination_causes(env, next_state), "t": torch.full_like(snap["t"], t)}
        snap = {k: torch.where(new_term, now[k], v) for k, v in snap.items()}
        alive = alive * (1.0 - terminated.float())
        state = next_state
    return alive, snap


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--angle", type=float, default=3.14159265)
    p.add_argument("--n-airframes", type=int, default=32)
    p.add_argument("--envs-per", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--adaptive", action="store_true",
                   help="per-airframe (w_cap, k_w) caps for the low-TWR/slow-motor tail "
                        "(env.recovery.adaptive_gain_caps)")
    p.add_argument("--c-flip", type=float, default=1.0)
    p.add_argument("--c-lag", type=float, default=0.8)
    p.add_argument("--c-bw", type=float, default=1.5)
    p.add_argument("--w-cap", type=float, default=10.0,
                   help="base w_cap ceiling; set very high with --adaptive to make the "
                        "per-airframe physics caps THE gains")
    p.add_argument("--k-w", type=float, default=30.0,
                   help="base rate-PD gain ceiling (see --w-cap)")
    p.add_argument("--grid", default=None,
                   help="semicolon list of adaptive 'c_flip:c_lag:c_bw' configs, each run "
                        "from the same seed; implies --adaptive. Example: '1:0.8:1.5;1:0.6:1.0'")
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    if args.grid:
        configs = []
        for item in args.grid.split(";"):
            cf, cl, cb = (float(x) for x in item.split(":"))
            configs.append(dict(c_flip=cf, c_lag=cl, c_bw=cb))
    elif args.adaptive:
        configs = [dict(c_flip=args.c_flip, c_lag=args.c_lag, c_bw=args.c_bw)]
    else:
        configs = [None]

    report = {"angle": args.angle, "controller": "geometric flip-arrest-hover",
              "adaptive": configs[0] is not None,
              "w_cap": args.w_cap, "k_w": args.k_w, "runs": []}
    env = L2F(EnvConfig(init=InitConfig(max_angle=args.angle)))
    m = args.n_airframes * args.envs_per
    for tag, airframe in [("aggregate", "random"), ("crazyflie", "crazyflie")]:
        gen = torch.Generator(device=device).manual_seed(args.seed)
        params = probe_airframes(airframe, gen, args.n_airframes, args.envs_per)
        reset_state = gen.get_state()
        for cfg in configs:
            gen.set_state(reset_state)  # every configuration from the same starts
            gains = {} if cfg is None else dict(adaptive=True, **cfg)
            alive, snap = rollout(env, params, gen, m, w_cap=args.w_cap, k_w=args.k_w, **gains)
            snap = {k: v.cpu().numpy() for k, v in snap.items()}
            died = snap["t"] >= 0
            entry = {
                "airframes": tag,
                "gains": cfg or "fixed (round-4 sweep optimum)",
                "episodes": m,
                "share_terminated": float(died.mean()),
                "mean_survival": float(
                    np.where(died, snap["t"], env.EPISODE_LENGTH).mean()
                ),
                "cause/position": float(snap["pos_hit"][died].mean()) if died.any() else None,
                "cause/angular_rate": float(snap["w_hit"][died].mean()) if died.any() else None,
            }
            report["runs"].append(entry)
            if len(configs) == 1:
                report[tag] = {k: v for k, v in entry.items()
                               if k not in ("airframes", "gains")}
    print(json.dumps(report, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
    return report


if __name__ == "__main__":
    main()
