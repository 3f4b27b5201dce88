"""Geometric recoverability bound for full-attitude initial states.

Counterpart of `raptor_tpu/apps/recoverability.py`, with the same flags plus
`--device` and the same report. For each sampled (airframe, initial state) it
computes an OPTIMISTIC recovery trajectory, in which every modelling choice
favours the policy, so a start this bound kills is unrecoverable by ANY
policy:

1. tilt angle theta0 between the body thrust axis and world up; the quad must
   rotate phi = max(0, theta0 - pi/2) before thrust has any upward component;
2. a bang-bang rotation at alpha = tau_max / I about the most favourable
   axis, tau_max from the best differential thrust split (positive-arm rotors
   at max thrust, the rest at zero), the initial angular velocity credited
   fully toward the rotation, the flip rate capped at the angular-velocity
   termination bound;
3. free fall during the rotation;
4. then instant alignment and max thrust, arresting the descent at
   a_up = T_max / m - g;
5. lateral drift ignored: only the z exit of the position box is tested.

`unrecoverable_lb` = P(z at arrest < -position_bound) is a LOWER bound on the
unrecoverable share. Every tensor is batched over the env axis:

    python -m raptor_tpu_torch.apps.recoverability [--n 4096] [--out report.json]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math

import torch

from raptor_tpu_torch.device import resolve_device
from raptor_tpu_torch.env import EnvConfig, InitConfig, L2F, sample_population
from raptor_tpu_torch.env.types import DynamicsParams, State

G = 9.81
ANGLES = (0.5, 1.0, 1.5, 2.0, 2.5, 3.14159265)


def arrest_height(env: L2F, params: DynamicsParams, state: State) -> torch.Tensor:
    """[N]: the lowest height z of the optimistic recovery of [N] airframes
    from [N] states."""
    q = state.orientation  # (w, x, y, z)
    # world z-component of the body thrust axis R @ e_z
    up = 1.0 - 2.0 * (q[:, 1] * q[:, 1] + q[:, 2] * q[:, 2])
    theta0 = torch.arccos(torch.clamp(up, -1.0, 1.0))
    phi = torch.clamp(theta0 - math.pi / 2.0, min=0.0)

    c = params.thrust_curve
    t_rotor_max = c[:, 0] + c[:, 1] * params.rpm_max + c[:, 2] * params.rpm_max**2
    a_up = 4.0 * t_rotor_max / params.mass - G  # > 0 for every sampled frame

    # most favourable roll/pitch axis with the best differential split:
    # rotors on the positive arm at T_max, the rest at zero thrust
    tau_x = torch.sum(torch.clamp(params.rotor_positions[:, :, 1], min=0.0), -1) * t_rotor_max
    tau_y = torch.sum(torch.clamp(params.rotor_positions[:, :, 0], min=0.0), -1) * t_rotor_max
    alpha = torch.maximum(tau_x * params.inertia_diag_inv[:, 0],
                          tau_y * params.inertia_diag_inv[:, 1])
    # initial angular velocity credited fully toward the rotation, flip rate
    # capped at the termination bound: a surviving policy never exceeds it
    w_cap = env.config.termination.angular_velocity_bound
    w0 = torch.clamp(torch.linalg.norm(state.angular_velocity, dim=-1), max=w_cap)
    # accelerate w0 -> w_cap (covering phi_acc), then coast at w_cap
    phi_acc = (w_cap * w_cap - w0 * w0) / (2.0 * alpha)
    t_uncapped = (torch.sqrt(w0 * w0 + 2.0 * alpha * phi) - w0) / alpha
    t_capped = (w_cap - w0) / alpha + (phi - phi_acc) / w_cap
    t_rot = torch.where(phi <= phi_acc, t_uncapped, t_capped)

    v0 = state.linear_velocity[:, 2]
    z1 = state.position[:, 2] + v0 * t_rot - 0.5 * G * t_rot * t_rot
    v1 = v0 - G * t_rot
    # arrest only needed while still descending
    drop2 = torch.where(v1 < 0.0, v1 * v1 / (2.0 * a_up), torch.zeros_like(v1))
    return z1 - drop2


def unrecoverable_lower_bound(env: L2F, params: DynamicsParams, state: State) -> torch.Tensor:
    """[N] float: 1.0 where the optimistic-recovery bound still exits the z
    box, for [N] airframes and states."""
    return (arrest_height(env, params, state) < -env.config.termination.position_bound).float()


@torch.no_grad()
def measure(n: int = 4096, angles=ANGLES, seed: int = 0, device="cuda") -> dict:
    """Monte-Carlo the bound over n fresh airframes and initial states per
    init max_angle; every angle draws from the same seed."""
    device = resolve_device(device)
    report = {"n": n, "angles": list(angles), "unrecoverable_lb": []}
    base = EnvConfig()
    for a in angles:
        env = L2F(dataclasses.replace(base, init=InitConfig(max_angle=float(a))))
        gen = torch.Generator(device=device).manual_seed(seed)
        params = sample_population(gen, n)
        state = env.sample_state(params, gen)
        report["unrecoverable_lb"].append(
            float(unrecoverable_lower_bound(env, params, state).mean()))
    return report


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--out", default=None)
    ap.add_argument("--eval-parity", default=None,
                    help="eval_parity sweep JSON to annotate with measured termination shares")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    report = measure(args.n, device=args.device)
    if args.eval_parity:
        # annotation only: a file that cannot be read is reported, and the
        # bound stands
        try:
            with open(args.eval_parity) as f:
                report["measured_eval_parity"] = json.load(f)
        except (OSError, ValueError) as e:
            report["measured_eval_parity_error"] = repr(e)
    print(json.dumps(report, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
    return report


if __name__ == "__main__":
    main()
