"""Types of the quadrotor environment: batched state and airframe parameters
as dataclasses of tensors with a leading [N] axis, and the static configs.

Counterpart of `raptor_tpu/env/types.py`; every config default is copied
from there unchanged. `State` and `DynamicsParams` also convert to and from
the structure-of-arrays layout the kernels read ([17, N] and [42, N], row
order of `raptor_tpu/ops/pallas_rollout.py:64-119`).
"""

from __future__ import annotations

import dataclasses

import torch

N_STATE = 17
N_PARAM = 42


def tree_map(fn, tree, *rest):
    """Apply `fn` leafwise over dataclasses of tensors of the same type."""
    if dataclasses.is_dataclass(tree):
        return type(tree)(
            **{
                f.name: tree_map(
                    fn, getattr(tree, f.name), *(getattr(r, f.name) for r in rest)
                )
                for f in dataclasses.fields(tree)
            }
        )
    return fn(tree, *rest)


def where(cond: torch.Tensor, a, b):
    """Per-env select between two trees: `a` where cond [N] is true, else `b`."""
    return tree_map(
        lambda x, y: torch.where(cond.view((-1,) + (1,) * (x.dim() - 1)), x, y),
        a,
        b,
    )


@dataclasses.dataclass
class State:
    """Rigid-body state of N quadrotors."""

    position: torch.Tensor  # [N, 3] world FLU, m
    orientation: torch.Tensor  # [N, 4] quaternion (w, x, y, z), body -> world
    linear_velocity: torch.Tensor  # [N, 3] world, m/s
    angular_velocity: torch.Tensor  # [N, 3] BODY frame, rad/s
    rpm: torch.Tensor  # [N, 4] normalized rotor speeds

    def to_soa(self) -> torch.Tensor:
        """[17, N] f32: p(3) q(4) v(3) w(3) rpm(4)."""
        return torch.cat(
            [
                self.position.T,
                self.orientation.T,
                self.linear_velocity.T,
                self.angular_velocity.T,
                self.rpm.T,
            ]
        ).contiguous()

    @classmethod
    def from_soa(cls, rows: torch.Tensor) -> "State":
        return cls(
            position=rows[0:3].T,
            orientation=rows[3:7].T,
            linear_velocity=rows[7:10].T,
            angular_velocity=rows[10:13].T,
            rpm=rows[13:17].T,
        )


@dataclasses.dataclass
class DynamicsParams:
    """Parameters of N airframes.

    thrust_curve maps normalized rotor speed u in [0, 1] to thrust in N:
    T(u) = c0 + c1*u + c2*u^2.
    """

    mass: torch.Tensor  # [N] kg
    inertia_diag: torch.Tensor  # [N, 3] body-frame diagonal inertia, kg m^2
    inertia_diag_inv: torch.Tensor  # [N, 3]
    rotor_positions: torch.Tensor  # [N, 4, 3] body frame, m; [FR, BR, BL, FL]
    rotor_thrust_directions: torch.Tensor  # [N, 4, 3] unit vectors
    rotor_torque_signs: torch.Tensor  # [N, 4] reaction-torque sign per rotor
    thrust_curve: torch.Tensor  # [N, 3] (c0, c1, c2)
    torque_constant: torch.Tensor  # [N] yaw moment = k * thrust (m)
    rpm_min: torch.Tensor  # [N]
    rpm_max: torch.Tensor  # [N]
    motor_time_constant: torch.Tensor  # [N] first-order rotor lag, s
    disturbance_force_std: torch.Tensor  # [N] N, world-frame force noise
    disturbance_torque_std: torch.Tensor  # [N] N m, body-frame torque noise

    def to_soa(self) -> torch.Tensor:
        """[42, N] f32 in the kernels' row order (the disturbance scales are
        not part of it: the kernels step deterministically)."""
        n = self.mass.shape[0]
        return torch.cat(
            [
                self.mass[None],
                self.inertia_diag.T,
                self.inertia_diag_inv.T,
                self.rotor_positions.reshape(n, 12).T,
                self.rotor_thrust_directions.reshape(n, 12).T,
                self.rotor_torque_signs.T,
                self.thrust_curve.T,
                self.torque_constant[None],
                self.rpm_min[None],
                self.rpm_max[None],
                self.motor_time_constant[None],
            ]
        ).contiguous()

    @classmethod
    def from_soa(cls, rows: torch.Tensor) -> "DynamicsParams":
        n = rows.shape[1]
        zeros = rows.new_zeros(n)
        return cls(
            mass=rows[0],
            inertia_diag=rows[1:4].T,
            inertia_diag_inv=rows[4:7].T,
            rotor_positions=rows[7:19].T.reshape(n, 4, 3),
            rotor_thrust_directions=rows[19:31].T.reshape(n, 4, 3),
            rotor_torque_signs=rows[31:35].T,
            thrust_curve=rows[35:38].T,
            torque_constant=rows[38],
            rpm_min=rows[39],
            rpm_max=rows[40],
            motor_time_constant=rows[41],
            disturbance_force_std=zeros,
            disturbance_torque_std=zeros,
        )


# ---------------------------------------------------------------------------
# static configs (defaults identical to raptor_tpu/env/types.py)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RewardConfig:
    """Weighted quadratic state/action penalties + survival constant."""

    scale: float = 1.0
    constant: float = 1.5  # survival bonus per step
    position_weight: float = 1.0
    orientation_weight: float = 0.1
    linear_velocity_weight: float = 0.05
    angular_velocity_weight: float = 0.005
    action_weight: float = 0.1  # penalizes deviation from hover command
    termination_penalty: float = 0.0


@dataclasses.dataclass(frozen=True)
class TerminationConfig:
    position_bound: float = 0.6  # m, per-axis |p_i|
    linear_velocity_bound: float = 1000.0  # m/s (effectively off)
    angular_velocity_bound: float = 35.0  # rad/s


@dataclasses.dataclass(frozen=True)
class InitConfig:
    """Initial-state ranges. angle = max_angle * u^(1/angle_power), u ~ U[0, 1)."""

    position_range: float = 0.3  # m, uniform box half-width
    max_angle: float = 3.14159265  # rad
    angle_power: float = 1.0
    linear_velocity_std: float = 0.1  # m/s
    angular_velocity_std: float = 0.1  # rad/s
    rpm_at_hover: bool = True  # start rotors near hover speed


def eval_parity_init() -> InitConfig:
    """The eval-parity initial-state distribution (attitudes up to 1 rad), the
    one the committed students' `eval_parity_*.json` numbers were taken at."""
    return InitConfig(max_angle=1.0)


@dataclasses.dataclass(frozen=True)
class ObservationConfig:
    """Position(3) . RotationMatrix(9) . LinearVelocity(3) .
    AngularVelocityDelayed(d)(3) . ActionHistory(h)(4h) [. privileged tail]."""

    action_history_length: int = 1
    angular_velocity_delay: int = 0
    privileged: bool = True  # append normalized params tail


@dataclasses.dataclass(frozen=True)
class EnvConfig:
    dt: float = 0.01  # control interval, 100 Hz
    integrator: str = "rk4"  # "rk4" | "euler"
    episode_length: int = 500
    reward: RewardConfig = dataclasses.field(default_factory=RewardConfig)
    termination: TerminationConfig = dataclasses.field(
        default_factory=TerminationConfig
    )
    init: InitConfig = dataclasses.field(default_factory=InitConfig)
    observation: ObservationConfig = dataclasses.field(
        default_factory=ObservationConfig
    )


POLICY_OBS_DIM = 22
PRIVILEGED_TAIL_DIM = 9


def observation_dim(config: EnvConfig) -> int:
    base = 18 + 4 * config.observation.action_history_length
    return base + (PRIVILEGED_TAIL_DIM if config.observation.privileged else 0)
