"""Canonical airframes: crazyflie (27 g) and x500-class (2 kg).

Counterpart of `raptor_tpu/env/presets.py`. X configuration, FLU body frame,
rotor order [front-right, back-right, back-left, front-left], reaction-torque
signs alternating around the perimeter. Each preset is a batch of one.
"""

from __future__ import annotations

import numpy as np
import torch

from raptor_tpu_torch.env.types import DynamicsParams

GRAVITY = 9.81
ROTOR_TORQUE_SIGNS = np.array([-1.0, 1.0, -1.0, 1.0], np.float32)  # FR,BR,BL,FL


def x_config_rotor_positions(arm_length: float) -> np.ndarray:
    """Rotor positions [4, 3] of an X quad with this center-to-rotor distance."""
    l = arm_length / np.sqrt(2.0)
    return np.array(
        [[l, -l, 0.0], [-l, -l, 0.0], [-l, l, 0.0], [l, l, 0.0]], np.float32
    )


def make_params(
    mass: float,
    arm_length: float,
    inertia_diag=None,
    thrust_to_weight: float = 2.5,
    torque_constant: float = 0.016,
    motor_time_constant: float = 0.05,
    rpm_min: float = 0.1,
    disturbance_force_std: float = 0.0,
    disturbance_torque_std: float = 0.0,
    device="cpu",
) -> DynamicsParams:
    """One airframe from physical numbers, as a batch of one.

    Thrust curve T(u) = c2 u^2 with c2 = thrust_to_weight * m * g / 4."""
    if inertia_diag is None:
        j_xy = 0.25 * mass * arm_length**2
        inertia_diag = np.array([j_xy, j_xy, 2.0 * j_xy], np.float32)
    inertia_diag = np.asarray(inertia_diag, np.float32)
    c2 = thrust_to_weight * mass * GRAVITY / 4.0

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)[None]

    return DynamicsParams(
        mass=t(mass),
        inertia_diag=t(inertia_diag),
        inertia_diag_inv=t(1.0 / inertia_diag),
        rotor_positions=t(x_config_rotor_positions(arm_length)),
        rotor_thrust_directions=t(np.tile([0.0, 0.0, 1.0], (4, 1))),
        rotor_torque_signs=t(ROTOR_TORQUE_SIGNS),
        thrust_curve=t([0.0, 0.0, c2]),
        torque_constant=t(torque_constant),
        rpm_min=t(rpm_min),
        rpm_max=t(1.0),
        motor_time_constant=t(motor_time_constant),
        disturbance_force_std=t(disturbance_force_std),
        disturbance_torque_std=t(disturbance_torque_std),
    )


def crazyflie(device="cpu") -> DynamicsParams:
    """Bitcraze Crazyflie 2.x (27 g)."""
    return make_params(
        mass=0.027,
        arm_length=0.046,
        inertia_diag=np.array([1.4e-5, 1.4e-5, 2.17e-5], np.float32),
        thrust_to_weight=1.9,
        torque_constant=0.006,
        motor_time_constant=0.035,
        device=device,
    )


def x500(device="cpu") -> DynamicsParams:
    """X500-class development quad (~2 kg)."""
    return make_params(
        mass=2.0,
        arm_length=0.25,
        inertia_diag=np.array([0.02, 0.02, 0.04], np.float32),
        thrust_to_weight=2.6,
        torque_constant=0.016,
        motor_time_constant=0.06,
        device=device,
    )
