"""Domain randomization: airframes spanning the crazyflie <-> x500 class.

Counterpart of `raptor_tpu/env/randomization.py`. The ranges and the
distributions are the same; the random streams are not (a `torch.Generator`
in place of `jax.random` keys), so populations agree in distribution, not
bit for bit. Everything is drawn on the generator's device.

`sample_population` makes every draw first, in the order and shapes
`population_draws` gives, and then derives every leaf from those draws alone
(`_population_from_draws`). The draws' order and shapes are part of the API:
the benchmark's reference sampler draws them again from the same seed, and
the generator's state after a call is that of these draws. On a card the
arithmetic runs as one CUDA graph replay (`utils.graphs`).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from raptor_tpu_torch.env import presets
from raptor_tpu_torch.env.types import DynamicsParams
from raptor_tpu_torch.utils import graphs
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


def _scale(u, lo, hi):
    """A uniform draw u in [0, 1) mapped onto [lo, hi)."""
    return lo + u * (hi - lo)


def _log_scale(u, minval, maxval):
    """A uniform draw u in [0, 1) mapped log-uniformly onto [minval, maxval)."""
    return torch.exp(_scale(u, math.log(minval), math.log(maxval)))


def log_uniform(generator, shape, minval, maxval):
    u = torch.rand(shape, generator=generator, device=generator.device)
    return _log_scale(u, minval, maxval)


def population_draws(n: int):
    """The draws of `sample_population(generator, n)`, in order: `(kind,
    shape)` each, as `graphs.draw` makes them. Their order and shapes are
    part of the API: the benchmark's reference sampler
    (`benchmark/reference/quad.py` `sample_airframes`) draws them again from
    the same seed."""
    return (
        ("rand", (n,)),  # mass, log-uniform
        ("randn", (n,)),  # arm length's spread
        ("rand", (n,)),  # j_factor
        ("rand", (n,)),  # jz_ratio
        ("rand", (n,)),  # thrust to weight
        ("rand", (n,)),  # torque constant, relative to the arm
        ("rand", (n,)),  # motor time constant, log-uniform
        ("rand", (n,)),  # rpm_min
        ("randn", (n, 4, 3)),  # rotor position jitter
        ("randn", (n, 4, 2)),  # thrust axis tilt
        ("rand", (n,)),  # thrust curve's linear mix
    )


_GRAPHED = graphs.Graphed("sample_population")
_CONSTANTS: dict = {}


def _constants(device: torch.device):
    """(base rotor positions [4, 3] at unit arm, rotor torque signs [4]) on
    `device`, made once a device."""
    if device not in _CONSTANTS:
        _CONSTANTS[device] = (
            torch.tensor(presets.x_config_rotor_positions(1.0), device=device),
            torch.tensor(presets.ROTOR_TORQUE_SIGNS, device=device),
        )
    return _CONSTANTS[device]


def sample_population(
    generator: torch.Generator,
    n: int,
    config: RandomizationConfig = RandomizationConfig(),
) -> DynamicsParams:
    """n randomized airframes, [n]-leading, on the generator's device.

    The draws come first (`population_draws`, on `generator`), then the
    arithmetic (`_population_from_draws`), which on a card is one CUDA graph
    replay from the third call with the same `n`, config and device
    (`utils.graphs`); its leaves are views of one buffer of the call's own."""
    with span("env.sample_population"):
        leaves = _GRAPHED((n, config), generator, population_draws(n),
                          lambda draws, _: _population_from_draws(draws, config))
        return DynamicsParams(*leaves)


def _population_from_draws(draws, config: RandomizationConfig):
    """The leaves of `DynamicsParams`, in its field order, from the draws of
    `population_draws`."""
    c = config
    u_mass, normal, u_j, u_jz, u_t2w, u_kappa, u_tm, u_rpm, jitter, tilt, u_mix = draws
    n, dev = u_mass.shape[0], u_mass.device
    mass = _log_scale(u_mass, c.mass_min, c.mass_max)
    arm = 0.046 * (mass / 0.027) ** (1.0 / 3.0) * torch.exp(
        normal * c.arm_length_rel_std * 0.5
    )
    j_factor = _scale(u_j, c.j_factor_min, c.j_factor_max)
    jz_ratio = _scale(u_jz, c.jz_ratio_min, c.jz_ratio_max)
    j_xy = j_factor * mass * arm**2
    inertia = torch.stack([j_xy, j_xy, jz_ratio * j_xy], -1)

    t2w = _scale(u_t2w, c.thrust_to_weight_min, c.thrust_to_weight_max)
    kappa = _scale(u_kappa, c.torque_constant_rel_min, c.torque_constant_rel_max) * arm
    t_m = _log_scale(u_tm, c.motor_time_constant_min, c.motor_time_constant_max)
    rpm_min = _scale(u_rpm, c.rpm_min_min, c.rpm_min_max)

    base_pos, torque_signs = _constants(dev)
    jitter = jitter * c.rotor_position_jitter
    rotor_positions = (base_pos + jitter) * arm[:, None, None]

    tilt = tilt * c.thrust_axis_tilt_std
    thrust_dirs = torch.stack(
        [
            torch.sin(tilt[..., 0]),
            torch.sin(tilt[..., 1]) * torch.cos(tilt[..., 0]),
            torch.cos(tilt[..., 1]) * torch.cos(tilt[..., 0]),
        ],
        -1,
    )

    a_mix = _scale(u_mix, 0.0, c.thrust_curve_linear_mix_max)
    t_max_rotor = t2w * mass * presets.GRAVITY / 4.0
    thrust_curve = torch.stack(
        [torch.zeros_like(a_mix), a_mix * t_max_rotor, (1.0 - a_mix) * t_max_rotor], -1
    )

    def full(v):
        return torch.full((n,), v, dtype=torch.float32, device=dev)

    return [
        mass,
        inertia,
        1.0 / inertia,
        rotor_positions,
        thrust_dirs,
        torque_signs.expand(n, 4).contiguous(),
        thrust_curve,
        kappa,
        rpm_min,
        full(1.0),
        t_m,
        full(c.disturbance_force_std),
        full(c.disturbance_torque_std),
    ]


def sample_dynamics_params(
    generator: torch.Generator, config: RandomizationConfig = RandomizationConfig()
) -> DynamicsParams:
    """One randomized airframe, as a batch of one."""
    return sample_population(generator, 1, config)
