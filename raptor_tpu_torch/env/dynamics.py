"""Rigid-body quadrotor dynamics, batched over N airframes: rotor lag ODE +
Newton-Euler + quaternion kinematics, RK4 (or Euler) at dt = 0.01 s.

Counterpart of `raptor_tpu/env/dynamics.py`, written on [N]-leading tensors
instead of one env under vmap.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from raptor_tpu_torch.env import maths
from raptor_tpu_torch.env.types import DynamicsParams, State, tree_map


def action_to_rpm_setpoint(params: DynamicsParams, action: torch.Tensor) -> torch.Tensor:
    """Normalized motor command [N, 4] in [-1, 1] -> rotor-speed setpoint in
    [rpm_min, rpm_max]."""
    a = torch.clamp(action, -1.0, 1.0)
    lo, hi = params.rpm_min[:, None], params.rpm_max[:, None]
    return lo + (a + 1.0) * 0.5 * (hi - lo)


def rotor_thrusts(params: DynamicsParams, rpm: torch.Tensor) -> torch.Tensor:
    """Per-rotor thrust [N, 4] from normalized rotor speed via
    T(u) = c0 + c1*u + c2*u^2."""
    c = params.thrust_curve
    return c[:, 0:1] + c[:, 1:2] * rpm + c[:, 2:3] * rpm * rpm


def derivative(
    params: DynamicsParams,
    state: State,
    rpm_setpoint: torch.Tensor,
    ext_force_world: torch.Tensor,
    ext_torque_body: torch.Tensor,
) -> State:
    """Time derivative of the state of every env."""
    thrust = rotor_thrusts(params, state.rpm)  # [N, 4]
    dirs = params.rotor_thrust_directions
    f_rotors = thrust[..., None] * dirs  # [N, 4, 3]
    force_body = torch.sum(f_rotors, 1)
    tau_arms = torch.sum(torch.linalg.cross(params.rotor_positions, f_rotors, dim=-1), 1)
    tau_reaction = torch.sum(
        (params.rotor_torque_signs * params.torque_constant[:, None] * thrust)[..., None]
        * dirs,
        1,
    )
    torque_body = tau_arms + tau_reaction + ext_torque_body

    accel = (
        maths.quat_rotate(state.orientation, force_body) + ext_force_world
    ) / params.mass[:, None]
    dv = torch.cat([accel[:, :2], accel[:, 2:] - 9.81], -1)  # + gravity

    j, j_inv = params.inertia_diag, params.inertia_diag_inv
    w = state.angular_velocity
    dw = j_inv * (torque_body - torch.linalg.cross(w, j * w, dim=-1))

    return State(
        position=state.linear_velocity,
        orientation=maths.quat_derivative(state.orientation, w),
        linear_velocity=dv,
        angular_velocity=dw,
        rpm=(rpm_setpoint - state.rpm) / params.motor_time_constant[:, None],
    )


def _axpy(state: State, d: State, h: float) -> State:
    return tree_map(lambda s, ds: s + h * ds, state, d)


def integrate(
    params: DynamicsParams,
    state: State,
    rpm_setpoint: torch.Tensor,
    dt: float,
    ext_force_world: torch.Tensor,
    ext_torque_body: torch.Tensor,
    method: str = "rk4",
) -> State:
    """One integration step; quaternion renormalized and rotor speed clipped
    to [0, rpm_max] afterwards."""

    def f(s: State) -> State:
        return derivative(params, s, rpm_setpoint, ext_force_world, ext_torque_body)

    if method == "euler":
        nxt = _axpy(state, f(state), dt)
    else:
        k1 = f(state)
        k2 = f(_axpy(state, k1, dt * 0.5))
        k3 = f(_axpy(state, k2, dt * 0.5))
        k4 = f(_axpy(state, k3, dt))
        nxt = tree_map(
            lambda s, a, b, c, d: s + (dt / 6.0) * (a + 2.0 * b + 2.0 * c + d),
            state, k1, k2, k3, k4,
        )
    nxt.orientation = maths.quat_normalize(nxt.orientation)
    nxt.rpm = torch.minimum(torch.clamp(nxt.rpm, min=0.0), params.rpm_max[:, None])
    return nxt


def hover_rpm(params: DynamicsParams) -> torch.Tensor:
    """Normalized rotor speed [N] at hover: the positive root of
    T(u) = m g / 4."""
    c0, c1, c2 = params.thrust_curve.unbind(-1)
    target = params.mass * 9.81 / 4.0 - c0
    small2 = torch.abs(c2) < 1e-8
    c2_safe = torch.where(small2, torch.full_like(c2, 1e-8), c2)
    disc = torch.sqrt(torch.clamp(c1 * c1 + 4.0 * c2_safe * target, min=0.0))
    u_quad = (-c1 + disc) / (2.0 * c2_safe)
    u_lin = target / torch.where(torch.abs(c1) < 1e-8, torch.full_like(c1, 1e-8), c1)
    return torch.clamp(torch.where(small2, u_lin, u_quad), 0.0, 1.0)


def hover_action(params: DynamicsParams) -> torch.Tensor:
    """Normalized motor command [N] that holds hover."""
    u = hover_rpm(params)
    span = torch.clamp(params.rpm_max - params.rpm_min, min=1e-6)
    return torch.clamp(2.0 * (u - params.rpm_min) / span - 1.0, -1.0, 1.0)


def sub_step(
    params: DynamicsParams,
    state: State,
    action: torch.Tensor,
    dt: float,
    ext_force_world: Optional[torch.Tensor] = None,
    ext_torque_body: Optional[torch.Tensor] = None,
    method: str = "rk4",
) -> Tuple[State, float]:
    """Dynamics-only control step: (next_state, dt)."""
    if ext_force_world is None:
        ext_force_world = torch.zeros_like(state.position)
    if ext_torque_body is None:
        ext_torque_body = torch.zeros_like(state.position)
    setpoint = action_to_rpm_setpoint(params, action)
    nxt = integrate(params, state, setpoint, dt, ext_force_world, ext_torque_body, method)
    return nxt, dt
