"""Label-regime composition of the scripted demonstrator's recovery from
full-attitude starts (counterpart of `tools/arrest_phase_probe.py`, the
evidence for `--demo-rate`):

    python -m raptor_tpu_torch.tools.arrest_phase_probe [--device cpu] [--seed 0] [--out r.json]

64 envs (8 random airframes x 8 starts, attitudes uniform up to pi) fly
`env.recovery.recovery_action` through the env's dynamics for 150 steps, an
eager loop; each visited state falls in one of the demo labeler's regimes:

  severe  tilt > 1.2           -> demo label (tilt-only criterion)
  arrest  tilt < 1.2, |w| > 5  -> teacher label under tilt-only switching,
                                  demo label under --demo-rate 5
  calm    tilt < 1.2, |w| <= 5 -> teacher label

The report has the JAX probe's keys. Its airframes and starts come from the
port's generators (`--seed`), so the shares agree with the JAX report in
distribution. Prints the report; writes it only where `--out` names a file.
"""

from __future__ import annotations

import argparse
import json
import math

import torch

from raptor_tpu_torch.device import resolve_device

N_AIRFRAMES, ENVS_PER, STEPS = 8, 8, 150


@torch.no_grad()
def trajectory(params, state, n_steps: int, env, generator=None):
    """tilt [T, N] and |w| [T, N] after each of n_steps demonstrator steps
    from `state`, and the first step's actions [N, 4]."""
    from raptor_tpu_torch.env.recovery import recovery_action, tilt_angle

    tilts, rates, first = [], [], None
    for _ in range(n_steps):
        act = recovery_action(params, state)
        first = act if first is None else first
        state, _ = env.dynamics_step(params, state, act, generator)
        tilts.append(tilt_angle(state.orientation))
        rates.append(torch.linalg.norm(state.angular_velocity, dim=-1))
    return torch.stack(tilts), torch.stack(rates), first


def report(tilt: torch.Tensor, w: torch.Tensor) -> dict:
    sev = tilt > 1.2
    arrest = ~sev & (w > 5.0)
    return {
        "steps": tilt.shape[0], "envs": tilt.shape[1],
        "share_severe_tilt_gt_1.2": float(sev.float().mean()),
        "share_arrest_tilt_lt_1.2_w_gt_5": float(arrest.float().mean()),
        "share_calm": float((~sev & (w <= 5.0)).float().mean()),
        "arrest_share_by_t": [float(arrest[t].float().mean()) for t in range(0, 40, 4)],
        "severe_share_by_t": [float(sev[t].float().mean()) for t in range(0, 40, 4)],
        "mean_w_by_t": [float(w[t].mean()) for t in range(0, 40, 4)],
    }


def run(device="cuda", seed: int = 0) -> dict:
    from raptor_tpu_torch.env import EnvConfig, InitConfig, L2F, sample_population
    from raptor_tpu_torch.env.types import tree_map

    dev = resolve_device(device)
    env = L2F(EnvConfig(init=InitConfig(max_angle=math.pi)))
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = tree_map(lambda x: x.repeat_interleave(ENVS_PER, 0),
                      sample_population(gen, N_AIRFRAMES))
    state = env.sample_state(params, gen)
    tilt, w, _ = trajectory(params, state, STEPS, env, gen)
    return report(tilt, w)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None, help="JSON report path")
    args = p.parse_args(argv)
    out = run(args.device, args.seed)
    print(json.dumps(out, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=2)
    return out


if __name__ == "__main__":
    main()
