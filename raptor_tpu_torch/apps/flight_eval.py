"""CLI: real-flight evaluation tooling.

Counterpart of `raptor_tpu/apps/flight_eval.py`, with the same modes and
flags plus `--device`. Three modes over the shared flight-log CSV schema
(`utils/flightlog.py`):

  record    fly a policy in the simulator and write the log a hardware
            bridge would have written (use --hover-start for a
            deployment-like takeoff from rest)
  analyze   hover-performance metrics from a log: position/velocity RMSE,
            max excursion, tilt statistics, control smoothness, crash
            detection against the sim termination bounds
  replay    sim-to-real gap: integrate the logged actions through the
            dynamics from the logged initial state and report trajectory
            divergence (the system-identification health check)

    python -m raptor_tpu_torch.apps.flight_eval record out.csv --checkpoint student.npz
    python -m raptor_tpu_torch.apps.flight_eval analyze out.csv
    python -m raptor_tpu_torch.apps.flight_eval replay out.csv --airframe crazyflie
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from raptor_tpu_torch.device import resolve_device
from raptor_tpu_torch.env import EnvConfig, InitConfig, L2F, dynamics, presets
from raptor_tpu_torch.env.types import State
from raptor_tpu_torch.utils import flightlog


def _log_states(log, rows: slice, device) -> State:
    """Rows of a log as a batched `State`; rotor speeds are unobservable and
    left at zero."""
    def t(x):
        return torch.as_tensor(np.asarray(x[rows], np.float32), device=device)

    return State(position=t(log.position), orientation=t(log.orientation),
                 linear_velocity=t(log.linear_velocity),
                 angular_velocity=t(log.angular_velocity),
                 rpm=torch.zeros((len(log.t_us[rows]), 4), device=device))


def _metrics(log, pos_setpoint, env, params, device) -> dict:
    pos_err = log.position - np.asarray(pos_setpoint, np.float32)
    tilt = np.arccos(
        np.clip(1.0 - 2.0 * (log.orientation[:, 1] ** 2 + log.orientation[:, 2] ** 2),
                -1.0, 1.0)
    )
    # crash detection IS the simulator's termination predicate (position /
    # linear-velocity / angular-velocity bounds + non-finite states) over the
    # log rows: one source of truth, env/quad.py terminated()
    crashed = bool(env.terminated(params, _log_states(log, slice(None), device)).any())
    out = {
        "duration_s": log.duration_s,
        "n_samples": int(len(log.t_us)),
        "rate_hz": (1.0 / log.dt_s) if log.dt_s > 0 else 0.0,
        "position_rmse_m": float(np.sqrt(np.mean(np.sum(pos_err**2, axis=1)))),
        "position_max_excursion_m": float(np.max(np.linalg.norm(pos_err, axis=1))),
        "velocity_rmse_mps": float(
            np.sqrt(np.mean(np.sum(log.linear_velocity**2, axis=1)))
        ),
        "tilt_mean_deg": float(np.degrees(np.mean(tilt))),
        "tilt_max_deg": float(np.degrees(np.max(tilt))),
        "crashed": crashed,
    }
    if log.action is not None:
        out["action_mean"] = [float(v) for v in np.mean(log.action, axis=0)]
        out["action_rate_rms"] = float(
            np.sqrt(np.mean(np.diff(log.action, axis=0) ** 2))
        )
    return out


def _row(state: State, action: torch.Tensor, t_us: int):
    return (t_us, *(getattr(state, k)[0].cpu().numpy() for k in (
        "position", "orientation", "linear_velocity", "angular_velocity")),
        action[0].cpu().numpy())


@torch.no_grad()
def _record(args, env, params, device):
    from raptor_tpu_torch.checkpoint import from_numpy, h5
    from raptor_tpu_torch.policy import network

    if args.shipped or not args.checkpoint:
        from raptor_tpu_torch.policy import shipped_checkpoint_path

        args.checkpoint = shipped_checkpoint_path()
    policy = from_numpy(h5.load_actor(args.checkpoint), device)
    es, _ = env.reset(params, torch.Generator(device=device).manual_seed(args.seed))
    h = network.initial_hidden(policy, 1)
    dt_us = int(round(env.config.dt * 1e6))

    def act(state, prev_a, h):
        obs = env.observe(params, state, prev_a)
        h2, a = network.apply_step(policy, h, obs[:, :22])
        return h2, torch.clamp(a, -1.0, 1.0)

    # manual closed loop (no auto-reset: a recorded flight must keep its
    # terminal out-of-bounds state in the log so `analyze` sees the crash,
    # and must never teleport through an episode truncation)
    state = es.dynamics
    prev_a = torch.zeros((1, 4), device=device)
    rows = []
    crashed_at = None
    for t in range(args.steps):
        h, a = act(state, prev_a, h)
        s2, _ = env.dynamics_step(params, state, a)
        rows.append(_row(state, a, t * dt_us))
        state, prev_a = s2, a
        if bool(env.terminated(params, s2)[0]):
            crashed_at = t + 1
            break
    # terminal state row (the crash frame, or the final hover state); its
    # action is the policy's command there: commanded, never integrated,
    # exactly what a real flight log's last frame holds
    _, a_T = act(state, prev_a, h)
    rows.append(_row(state, a_T, len(rows) * dt_us))
    if crashed_at is not None:
        print(f"terminated at step {crashed_at}")
    log = flightlog.FlightLog(
        t_us=np.asarray([r[0] for r in rows], np.int64),
        position=np.stack([r[1] for r in rows]),
        orientation=np.stack([r[2] for r in rows]),
        linear_velocity=np.stack([r[3] for r in rows]),
        angular_velocity=np.stack([r[4] for r in rows]),
        action=np.stack([r[5] for r in rows]),
    )
    flightlog.write_csv(args.log, log)
    print(f"{args.log}: {len(rows)} samples, {log.duration_s:.2f} s")
    return log


@torch.no_grad()
def _replay(log, env, params, device) -> dict:
    """Integrate the logged actions from the logged initial state."""
    state = _log_states(log, slice(0, 1), device)
    # rotor speeds are unobservable in mocap logs; start from the hover point
    # like the env's own rpm_at_hover initial state
    state.rpm = dynamics.hover_rpm(params)[:, None].expand(1, 4).contiguous()
    actions = torch.as_tensor(np.asarray(log.action[:-1], np.float32), device=device)
    sim_pos = []
    for a in actions:
        state, _ = env.dynamics_step(params, state, a[None])
        sim_pos.append(state.position[0])
    sim_pos = torch.stack(sim_pos).cpu().numpy()
    div = np.linalg.norm(sim_pos - log.position[1:], axis=1)
    steps_1s = max(1, int(round(1.0 / env.config.dt)))
    return {
        "n_steps": int(len(div)),
        "divergence_mean_m": float(np.mean(div)),
        "divergence_final_m": float(div[-1]),
        "divergence_at_1s_m": float(div[min(steps_1s - 1, len(div) - 1)]),
    }


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("mode", choices=("record", "analyze", "replay"))
    p.add_argument("log", help="flight-log CSV path")
    p.add_argument("--checkpoint", default=None, help="policy checkpoint, .h5 or .npz (record)")
    p.add_argument("--shipped", action="store_true",
                   help="record with the shipped reference policy")
    p.add_argument("--airframe", choices=("crazyflie", "x500"), default="crazyflie")
    p.add_argument("--steps", type=int, default=500)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--hover-start", action="store_true",
                   help="record from rest at the origin (deployment-like)")
    p.add_argument("--setpoint", type=float, nargs=3, default=(0.0, 0.0, 0.0))
    p.add_argument("--out", default=None, help="JSON report path (analyze/replay)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    params = getattr(presets, args.airframe)(device)
    env = L2F(EnvConfig(init=InitConfig(max_angle=0.0, position_range=0.0,
                                        linear_velocity_std=0.0, angular_velocity_std=0.0)
                        if args.hover_start else InitConfig(max_angle=0.5)))

    if args.mode == "record":
        return _record(args, env, params, device)

    log = flightlog.read_csv(args.log)
    if args.mode == "analyze":
        report = _metrics(log, args.setpoint, env, params, device)
    else:  # replay: sim-to-real gap from logged actions
        if log.action is None:
            raise SystemExit("replay requires action columns in the log")
        report = _replay(log, env, params, device)
    print(json.dumps(report, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
    return report


if __name__ == "__main__":
    main()
