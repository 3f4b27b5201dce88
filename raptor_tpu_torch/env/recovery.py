"""Scripted geometric full-attitude recovery controller, batched over N envs.

Counterpart of `raptor_tpu/env/recovery.py` (written there for one env under
`vmap`). The controller has privileged state and no learning; distillation
uses it as a demonstrator: collect states beyond a tilt (or body-rate)
threshold take its action as their DAgger label, and a share of the collect
envs can be flown by it.

Per step:
  1. attitude: rotate body +z onto a target direction, world up while tilted
     past `tilt_gate`, else the desired-acceleration direction (position /
     velocity PD). Desired body rate = axis * min(w_cap, k_theta * theta).
  2. torque = I (k_w (w_des - w)) + w x I w.
  3. collective thrust = m (a_des . z_b), clipped to the feasible range.
  4. allocation: solve the per-airframe 4x4 mixer (arm torques + reaction
     yaw) for per-rotor thrusts, clip, invert the quadratic thrust curve back
     to normalized commands.
"""

from __future__ import annotations

from typing import Tuple

import torch

from raptor_tpu_torch.env.dynamics import rotor_thrusts
from raptor_tpu_torch.env.maths import quat_to_rotm
from raptor_tpu_torch.env.types import DynamicsParams, State


def tilt_angle(orientation: torch.Tensor) -> torch.Tensor:
    """Angle [N] between body +z and world up, from unit quaternions [N, 4]."""
    return torch.acos(torch.clamp(quat_to_rotm(orientation)[..., 2, 2], -1.0, 1.0))


def adaptive_gain_caps(
    params: DynamicsParams,
    w_cap: float,
    k_w: float,
    c_flip: float = 1.0,
    c_lag: float = 0.8,
    c_bw: float = 1.5,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-airframe caps [N] on (w_cap, k_w) from three physical limits:
    flip authority (peak rate of a bang-bang flip, c_flip * sqrt(alpha_max),
    alpha_max the differential-thrust torque budget over inertia), motor lag
    on the arrest (c_lag / T_m) and on the rate loop's bandwidth
    (k_w <= c_bw / T_m). Fast, strong airframes keep the given gains."""
    t_min, t_max = _thrust_range(params)
    arm = torch.linalg.cross(params.rotor_positions, params.rotor_thrust_directions, dim=-1)
    dthr = 0.5 * (t_max - t_min)  # max per-rotor thrust deviation from mid
    tau_cap = torch.sum(torch.abs(arm[..., :2]), 1) * dthr[:, None]  # [N, 2] roll, pitch
    alpha_max = torch.min(tau_cap / params.inertia_diag[:, :2], -1).values
    tm = torch.clamp(params.motor_time_constant, min=1e-4)
    w_cap_eff = torch.minimum(
        torch.clamp(c_flip * torch.sqrt(alpha_max), max=w_cap), c_lag / tm
    )
    k_w_eff = torch.clamp(c_bw / tm, max=k_w)
    return w_cap_eff, k_w_eff


def _thrust_range(params: DynamicsParams) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-rotor thrust [N] at rpm_min and at rpm_max."""
    return (
        rotor_thrusts(params, params.rpm_min[:, None])[:, 0],
        rotor_thrusts(params, params.rpm_max[:, None])[:, 0],
    )


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=1e-6)


def recovery_action(
    params: DynamicsParams,
    state: State,
    k_theta: float = 8.0,
    w_cap: float = 10.0,
    k_w: float = 30.0,
    kp_p: float = 7.0,
    kd_p: float = 4.5,
    tilt_gate: float = 1.2,  # rad: above this, target pure upright
    adaptive: bool = False,  # per-airframe (w_cap, k_w) caps, see above
    c_flip: float = 1.0,
    c_lag: float = 0.8,
    c_bw: float = 1.5,
) -> torch.Tensor:
    """Actions [N, 4] in [-1, 1] from privileged state."""
    n = state.position.shape[0]
    if adaptive:
        w_cap_t, k_w_t = adaptive_gain_caps(params, w_cap, k_w, c_flip, c_lag, c_bw)
    else:
        w_cap_t, k_w_t = (state.position.new_full((n,), v) for v in (w_cap, k_w))
    rot = quat_to_rotm(state.orientation)  # body -> world
    z_b = rot[..., :, 2]
    z_w = state.position.new_tensor([0.0, 0.0, 1.0]).expand(n, 3)

    # desired acceleration (world) for the hover phase
    a_des = kp_p * (-state.position) + kd_p * (-state.linear_velocity)
    a_des = a_des + state.position.new_tensor([0.0, 0.0, 9.81])
    a_dir = _unit(a_des)

    tilt = torch.acos(torch.clamp(z_b[:, 2], -1.0, 1.0))
    z_des = _unit(torch.where((tilt > tilt_gate)[:, None], z_w, a_dir))

    # attitude error axis/angle (world), then body frame
    cr = torch.linalg.cross(z_b, z_des, dim=-1)
    s = torch.linalg.norm(cr, dim=-1)
    c = torch.sum(z_b * z_des, -1)
    theta = torch.atan2(s, c)
    # when anti-parallel the cross product vanishes: pick any axis normal to z_b
    e_x = state.position.new_tensor([1.0, 0.0, 0.0]).expand(n, 3)
    e_y = state.position.new_tensor([0.0, 1.0, 0.0]).expand(n, 3)
    fallback = torch.linalg.cross(z_b, e_x, dim=-1)
    fallback = torch.where(
        (torch.linalg.norm(fallback, dim=-1) < 1e-3)[:, None],
        torch.linalg.cross(z_b, e_y, dim=-1),
        fallback,
    )
    axis_w = torch.where(
        (s > 1e-4)[:, None], cr / torch.clamp(s, min=1e-6)[:, None], _unit(fallback)
    )
    axis_b = torch.einsum("nji,nj->ni", rot, axis_w)  # R^T axis_w

    w_des = axis_b * torch.minimum(w_cap_t, k_theta * theta)[:, None]
    inertia = params.inertia_diag
    w = state.angular_velocity
    tau = inertia * (k_w_t[:, None] * (w_des - w)) + torch.linalg.cross(w, inertia * w, dim=-1)

    # collective thrust: the component of a_des along body z, held at the
    # floor while the rotor axis points down (inverted thrust hurts)
    t_min, t_max = _thrust_range(params)
    t_total = params.mass * torch.sum(a_des * z_b, -1)
    t_total = torch.minimum(torch.maximum(t_total, 4.0 * t_min), 4.0 * t_max)

    # allocation: [T, tau] = A t  (t = per-rotor thrusts)
    d = params.rotor_thrust_directions  # [N, 4, 3] ~ body +z
    arm = torch.linalg.cross(params.rotor_positions, d, dim=-1)
    yaw = (params.rotor_torque_signs * params.torque_constant[:, None])[..., None] * d
    a_mat = torch.cat([d[..., 2:3].transpose(1, 2), (arm + yaw).transpose(1, 2)], 1)  # [N, 4, 4]
    rhs = torch.cat([t_total[:, None], tau], -1)
    eye = torch.eye(4, dtype=a_mat.dtype, device=a_mat.device)
    t = torch.linalg.solve(a_mat + 1e-6 * eye, rhs)
    t = torch.minimum(torch.maximum(t, t_min[:, None]), t_max[:, None])

    # invert the thrust curve T(u) = c0 + c1 u + c2 u^2 for u in [rpm_min, 1]
    c0, c1, c2 = (params.thrust_curve[:, i : i + 1] for i in range(3))
    disc = torch.clamp(c1 * c1 - 4.0 * c2 * (c0 - t), min=0.0)
    u = (-c1 + torch.sqrt(disc)) / (2.0 * c2)
    span = torch.clamp(params.rpm_max - params.rpm_min, min=1e-6)[:, None]
    return torch.clamp(2.0 * (u - params.rpm_min[:, None]) / span - 1.0, -1.0, 1.0)
