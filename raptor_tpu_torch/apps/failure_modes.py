"""CLI: classify WHY severe-attitude episodes terminate.

Counterpart of `raptor_tpu/apps/failure_modes.py`, with the same flags plus
`--device` and the same report. Each termination is attributed to the bound it
tripped (|p_i| > 0.6 m box, |w| > 35 rad/s, non-finite position), read on the
state that tripped it, together with when it happened: a failed flip ends
early, a drift after recovery late.

    python -m raptor_tpu_torch.apps.failure_modes \
        --checkpoint raptor_tpu_torch/data/student_rateFlagCurPure.npz --angle 3.14159 \
        --out failure_modes.json

The closed loop is an eager loop over `rl.evaluation.gru_policy_step` and
`L2F.dynamics_step` / `observe` / `terminated`: it needs a cause at every
step, which the eval kernel does not give.
"""

from __future__ import annotations

import argparse
import json
from typing import Optional

import numpy as np
import torch

from raptor_tpu_torch.checkpoint import from_numpy, h5
from raptor_tpu_torch.device import resolve_device
from raptor_tpu_torch.env import EnvConfig, InitConfig, L2F, presets, sample_population
from raptor_tpu_torch.env.types import DynamicsParams, State, tree_map, where
from raptor_tpu_torch.rl import evaluation


def probe_airframes(airframe: str, generator: torch.Generator, n_airframes: int,
                    envs_per: int) -> DynamicsParams:
    """[n_airframes * envs_per] airframes: `n_airframes` random ones, each
    repeated over `envs_per` envs, or one preset broadcast to all."""
    if airframe == "random":
        frames = sample_population(generator, n_airframes)
        return tree_map(lambda x: torch.repeat_interleave(x, envs_per, 0), frames)
    one = getattr(presets, airframe)(generator.device)
    m = n_airframes * envs_per
    return tree_map(lambda x: x.expand(m, *x.shape[1:]).contiguous(), one)


def termination_causes(env: L2F, state: State) -> dict:
    """Per env [N]: the bounds `state` trips, read apart."""
    c = env.config.termination
    return {
        "pos_hit": torch.any(torch.abs(state.position) > c.position_bound, -1),
        "w_hit": torch.sum(state.angular_velocity**2, -1) > c.angular_velocity_bound**2,
    }


def attitude_angle(q: torch.Tensor) -> torch.Tensor:
    """Rotation angle from identity: 2 acos(|q_w|)."""
    return 2.0 * torch.arccos(torch.clamp(torch.abs(q[:, 0]), 0.0, 1.0))


@torch.no_grad()
def probe(policy_params, angle: float, generator: torch.Generator, n_airframes: int,
          envs_per: int, airframe: str = "random", params: Optional[DynamicsParams] = None,
          state: Optional[State] = None, steps: Optional[int] = None):
    """One episode of the policy from `angle` starts on M = n_airframes x
    envs_per envs: (alive [M] float, snapshot) where the snapshot holds, per
    env, the step its episode terminated (-1 if it did not) and the causes
    read on the state that tripped the bound.

    `params` and `state` ([M] airframes and initial states) replace the
    draws from the generator where given; `steps` cuts the episode."""
    env = L2F(EnvConfig(init=InitConfig(max_angle=angle)))
    c = env.config.termination
    if params is None:
        params = probe_airframes(airframe, generator, n_airframes, envs_per)
    m = params.mass.shape[0]
    if state is None:
        state = env.reset(params, generator)[0].dynamics
    dev = params.mass.device
    obs = env.observe(params, state, state.position.new_zeros((m, 4)))
    policy_step, carry = evaluation.gru_policy_step(policy_params, m)

    alive = torch.ones(m, device=dev)
    snap = {
        "t": torch.full((m,), -1, dtype=torch.int32, device=dev),
        "pos_hit": torch.zeros(m, dtype=torch.bool, device=dev),
        "w_hit": torch.zeros(m, dtype=torch.bool, device=dev),
        "nonfinite": torch.zeros(m, dtype=torch.bool, device=dev),
        "z_exit": torch.zeros(m, dtype=torch.bool, device=dev),
        "z_sign": torch.zeros(m, device=dev),
        "angle_at_term": torch.zeros(m, device=dev),
        "w_norm": torch.zeros(m, device=dev),
    }
    for t in range(steps or env.EPISODE_LENGTH):
        carry, action = policy_step(carry, obs)
        action = torch.clamp(action, -1.0, 1.0)
        stepped, _ = env.dynamics_step(params, state, action, generator)
        # a dead env keeps the state it died in
        next_state = where(alive > 0.5, stepped, state)
        terminated = env.terminated(params, next_state)
        new_term = (alive > 0.5) & terminated
        # cause attribution on the state that tripped the bound
        now = {
            **termination_causes(env, next_state),
            "t": torch.full_like(snap["t"], t),
            "nonfinite": ~torch.all(torch.isfinite(next_state.position), -1),
            "z_exit": torch.abs(next_state.position[:, 2]) > c.position_bound,
            "z_sign": torch.sign(next_state.position[:, 2]),
            "angle_at_term": attitude_angle(next_state.orientation),
            "w_norm": torch.linalg.norm(next_state.angular_velocity, dim=-1),
        }
        snap = {k: torch.where(new_term, now[k], v) for k, v in snap.items()}
        alive = alive * (1.0 - terminated.float())
        state = next_state
        obs = env.observe(params, next_state, action)
    return alive, snap


def summarize(alive, snap):
    died = snap["t"] >= 0
    n = len(alive)
    nd = int(died.sum())
    out = {
        "episodes": n,
        "terminated": nd,
        "share_terminated": nd / n,
    }
    if nd == 0:
        return out
    d = {k: v[died] for k, v in snap.items()}
    t = d["t"].astype(float)
    out.update(
        {
            # cause shares (can overlap; pos-only/w-only split them)
            "cause/position_box": float(d["pos_hit"].mean()),
            "cause/angular_rate": float(d["w_hit"].mean()),
            "cause/position_only": float((d["pos_hit"] & ~d["w_hit"]).mean()),
            "cause/angular_only": float((d["w_hit"] & ~d["pos_hit"]).mean()),
            "cause/nonfinite": float(d["nonfinite"].mean()),
            "cause/z_exit_given_pos": float(
                d["z_exit"][d["pos_hit"]].mean()
            ) if d["pos_hit"].any() else None,
            "cause/z_down_given_z_exit": float(
                (d["z_sign"][d["z_exit"]] < 0).mean()
            ) if d["z_exit"].any() else None,
            "t_term/mean": float(t.mean()),
            "t_term/p10": float(np.percentile(t, 10)),
            "t_term/p50": float(np.percentile(t, 50)),
            "t_term/p90": float(np.percentile(t, 90)),
            "t_term/share_first_50": float((t < 50).mean()),
            "t_term/share_first_100": float((t < 100).mean()),
            "angle_at_term/mean": float(d["angle_at_term"].mean()),
            "angle_at_term/share_gt_90deg": float(
                (d["angle_at_term"] > np.pi / 2).mean()
            ),
            "w_norm_at_term/mean": float(d["w_norm"].mean()),
        }
    )
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--angle", type=float, default=3.14159265)
    p.add_argument("--n-airframes", type=int, default=32)
    p.add_argument("--envs-per", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    policy = from_numpy(h5.load_actor(args.checkpoint), device)
    report = {"checkpoint": args.checkpoint, "angle": args.angle}
    for tag, airframe in [("aggregate", "random"), ("crazyflie", "crazyflie")]:
        gen = torch.Generator(device=device).manual_seed(args.seed)
        alive, snap = probe(policy, args.angle, gen, args.n_airframes, args.envs_per, airframe)
        report[tag] = summarize(alive.cpu().numpy(), {k: v.cpu().numpy() for k, v in snap.items()})
    print(json.dumps(report, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
    return report


if __name__ == "__main__":
    main()
