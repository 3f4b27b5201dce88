"""Quaternion / rotation maths, batched over leading axes.

Counterpart of `raptor_tpu/env/maths.py`: FLU body frame, world z-up,
quaternions (w, x, y, z) in the Hamilton convention rotating BODY -> WORLD,
rotation matrices row-major.
"""

from __future__ import annotations

import math

import torch


def quat_to_rotm(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternions [..., 4] -> rotation matrices [..., 3, 3]."""
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    rows = [
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ]
    return torch.stack(rows, -1).reshape(q.shape[:-1] + (3, 3))


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a (x) b."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        -1,
    )


def quat_derivative(q: torch.Tensor, omega_body: torch.Tensor) -> torch.Tensor:
    """dq/dt = 0.5 * q (x) (0, w_body)."""
    omega_quat = torch.cat([torch.zeros_like(q[..., :1]), omega_body], -1)
    return 0.5 * quat_mul(q, omega_quat)


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q * torch.rsqrt(torch.sum(q * q, -1, keepdim=True))


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate body vectors v [..., 3] to the world frame (two cross products)."""
    qw, qv = q[..., :1], q[..., 1:]
    t = 2.0 * torch.linalg.cross(qv, v, dim=-1)
    return v + qw * t + torch.linalg.cross(qv, t, dim=-1)


def quat_from_axis_angle(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    half = 0.5 * angle
    return torch.cat([torch.cos(half)[..., None], torch.sin(half)[..., None] * axis], -1)


def random_quaternion(
    n: int,
    generator: torch.Generator,
    max_angle: float = math.pi,
    angle_power: float = 1.0,
) -> torch.Tensor:
    """n rotations up to max_angle about uniform random axes, [n, 4], on the
    generator's device. angle = max_angle * u^(1/angle_power). Draws a
    `randn` [n, 3] for the axes, then a `rand` [n] for u."""
    device = generator.device
    axis = torch.randn((n, 3), generator=generator, device=device)
    u = torch.rand((n,), generator=generator, device=device)
    return quaternion_from_draws(axis, u, max_angle, angle_power)


def quaternion_from_draws(
    axis: torch.Tensor, u: torch.Tensor, max_angle: float, angle_power: float
) -> torch.Tensor:
    """The arithmetic of `random_quaternion` on its draws: axis [n, 3]
    standard normal, u [n] uniform in [0, 1)."""
    axis = axis * torch.rsqrt(torch.sum(axis * axis, -1, keepdim=True) + 1e-12)
    if angle_power != 1.0:
        u = u ** (1.0 / angle_power)
    return quat_from_axis_angle(axis, u * max_angle)
