"""Domain randomization: airframes spanning the crazyflie <-> x500 class.

Counterpart of `raptor_tpu/env/randomization.py`. The ranges and the
distributions are the same; the random streams are not (a `torch.Generator`
in place of `jax.random` keys), so populations agree in distribution, not
bit for bit. Everything is drawn on the generator's device.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from raptor_tpu_torch.env import presets
from raptor_tpu_torch.env.types import DynamicsParams
from raptor_tpu_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class RandomizationConfig:
    mass_min: float = 0.025  # kg  (crazyflie 0.027)
    mass_max: float = 2.5  # kg  (x500-class ~2.0)
    # L = 0.046 * (m/0.027)^(1/3) * exp(N(0,1) * arm_length_rel_std / 2)
    arm_length_rel_std: float = 0.3
    # J_xy = j_factor * m * L^2, J_z = jz_ratio * J_xy
    j_factor_min: float = 0.15
    j_factor_max: float = 0.4
    jz_ratio_min: float = 1.3
    jz_ratio_max: float = 2.2
    thrust_to_weight_min: float = 1.5
    thrust_to_weight_max: float = 4.0
    torque_constant_rel_min: float = 0.08  # kappa = rel * arm_length
    torque_constant_rel_max: float = 0.22
    motor_time_constant_min: float = 0.015
    motor_time_constant_max: float = 0.12
    rpm_min_min: float = 0.05
    rpm_min_max: float = 0.25
    rotor_position_jitter: float = 0.05  # per-rotor, relative to arm length
    thrust_axis_tilt_std: float = 0.02  # rad
    thrust_curve_linear_mix_max: float = 0.3  # T = c2*((1-a)*u^2 + a*u)
    disturbance_force_std: float = 0.0
    disturbance_torque_std: float = 0.0


def _uniform(generator, shape, lo, hi):
    u = torch.rand(shape, generator=generator, device=generator.device)
    return lo + u * (hi - lo)


def log_uniform(generator, shape, minval, maxval):
    return torch.exp(_uniform(generator, shape, math.log(minval), math.log(maxval)))


def sample_population(
    generator: torch.Generator,
    n: int,
    config: RandomizationConfig = RandomizationConfig(),
) -> DynamicsParams:
    """n randomized airframes, [n]-leading, on the generator's device."""
    with span("env.sample_population"):
        return _sample_population(generator, n, config)


def _sample_population(
    generator: torch.Generator, n: int, config: RandomizationConfig
) -> DynamicsParams:
    c = config
    g = generator
    mass = log_uniform(g, (n,), c.mass_min, c.mass_max)
    normal = torch.randn((n,), generator=g, device=g.device)
    arm = 0.046 * (mass / 0.027) ** (1.0 / 3.0) * torch.exp(
        normal * c.arm_length_rel_std * 0.5
    )
    j_factor = _uniform(g, (n,), c.j_factor_min, c.j_factor_max)
    jz_ratio = _uniform(g, (n,), c.jz_ratio_min, c.jz_ratio_max)
    j_xy = j_factor * mass * arm**2
    inertia = torch.stack([j_xy, j_xy, jz_ratio * j_xy], -1)

    t2w = _uniform(g, (n,), c.thrust_to_weight_min, c.thrust_to_weight_max)
    kappa = _uniform(g, (n,), c.torque_constant_rel_min, c.torque_constant_rel_max) * arm
    t_m = log_uniform(g, (n,), c.motor_time_constant_min, c.motor_time_constant_max)
    rpm_min = _uniform(g, (n,), c.rpm_min_min, c.rpm_min_max)

    base_pos = torch.as_tensor(presets.x_config_rotor_positions(1.0), device=g.device)
    jitter = torch.randn((n, 4, 3), generator=g, device=g.device) * c.rotor_position_jitter
    rotor_positions = (base_pos + jitter) * arm[:, None, None]

    tilt = torch.randn((n, 4, 2), generator=g, device=g.device) * c.thrust_axis_tilt_std
    thrust_dirs = torch.stack(
        [
            torch.sin(tilt[..., 0]),
            torch.sin(tilt[..., 1]) * torch.cos(tilt[..., 0]),
            torch.cos(tilt[..., 1]) * torch.cos(tilt[..., 0]),
        ],
        -1,
    )

    a_mix = _uniform(g, (n,), 0.0, c.thrust_curve_linear_mix_max)
    t_max_rotor = t2w * mass * presets.GRAVITY / 4.0
    thrust_curve = torch.stack(
        [torch.zeros_like(a_mix), a_mix * t_max_rotor, (1.0 - a_mix) * t_max_rotor], -1
    )

    def full(v):
        return torch.full((n,), v, dtype=torch.float32, device=g.device)

    return DynamicsParams(
        mass=mass,
        inertia_diag=inertia,
        inertia_diag_inv=1.0 / inertia,
        rotor_positions=rotor_positions,
        rotor_thrust_directions=thrust_dirs,
        rotor_torque_signs=torch.as_tensor(presets.ROTOR_TORQUE_SIGNS, device=g.device)
        .expand(n, 4)
        .contiguous(),
        thrust_curve=thrust_curve,
        torque_constant=kappa,
        rpm_min=rpm_min,
        rpm_max=full(1.0),
        motor_time_constant=t_m,
        disturbance_force_std=full(c.disturbance_force_std),
        disturbance_torque_std=full(c.disturbance_torque_std),
    )


def sample_dynamics_params(
    generator: torch.Generator, config: RandomizationConfig = RandomizationConfig()
) -> DynamicsParams:
    """One randomized airframe, as a batch of one."""
    return sample_population(generator, 1, config)
