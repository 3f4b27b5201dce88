"""Plain reference of the closed-loop evaluation: the airframe sampler, the
initial-state sampler, the quadrotor dynamics (rotor lag, Newton-Euler,
quaternion kinematics, RK4 at dt), reward, termination and the recurrent
policy, written on [N]-leading float32 tensors in plain PyTorch.

It imports nothing of the system under test. It follows the published
environment (the RAPTOR L2F simulator) term for term, and draws its random
numbers from a `torch.Generator` in the order the system's sampler documents
(mass, arm length, inertia, thrust-to-weight, torque constant, motor time
constant, minimum speed, rotor jitter, thrust tilt, thrust-curve mix; then
position, attitude axis and angle, linear and angular velocity), so the same
seed gives the same airframes and initial states.

`precision="tf32"` rounds both operands of every policy matmul to TF32 (10
mantissa bits): the control that a correct comparison has to reject.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from reference.tf32 import matmul

GRAVITY = 9.81
ROTOR_TORQUE_SIGNS = (-1.0, 1.0, -1.0, 1.0)  # front-right, back-right, back-left, front-left

# the domain-randomization ranges of the crazyflie <-> x500 class
RANDOMIZATION = dict(
    mass=(0.025, 2.5), arm_length_rel_std=0.3, j_factor=(0.15, 0.4), jz_ratio=(1.3, 2.2),
    thrust_to_weight=(1.5, 4.0), torque_constant_rel=(0.08, 0.22),
    motor_time_constant=(0.015, 0.12), rpm_min=(0.05, 0.25), rotor_position_jitter=0.05,
    thrust_axis_tilt_std=0.02, thrust_curve_linear_mix_max=0.3,
)

# the kernels' structure-of-arrays rows: params [42, N], state [17, N]
PARAM_ROWS = (("mass", 1), ("inertia", 3), ("inertia_inv", 3), ("rotor_pos", 12),
              ("thrust_dir", 12), ("torque_sign", 4), ("thrust_curve", 3),
              ("torque_constant", 1), ("rpm_min", 1), ("rpm_max", 1), ("motor_tau", 1))
STATE_ROWS = (("p", 3), ("q", 4), ("v", 3), ("w", 3), ("rpm", 4))


def _uniform(g, shape, lo, hi):
    return lo + torch.rand(shape, generator=g, device=g.device) * (hi - lo)


def _log_uniform(g, shape, lo, hi):
    return torch.exp(_uniform(g, shape, math.log(lo), math.log(hi)))


def sample_airframes(g: torch.Generator, n: int) -> Dict[str, torch.Tensor]:
    """n randomized airframes as a dict of [n, ...] tensors."""
    c, dev = RANDOMIZATION, g.device
    mass = _log_uniform(g, (n,), *c["mass"])
    normal = torch.randn((n,), generator=g, device=dev)
    arm = 0.046 * (mass / 0.027) ** (1.0 / 3.0) * torch.exp(normal * c["arm_length_rel_std"] * 0.5)
    j_factor = _uniform(g, (n,), *c["j_factor"])
    jz_ratio = _uniform(g, (n,), *c["jz_ratio"])
    j_xy = j_factor * mass * arm**2
    inertia = torch.stack([j_xy, j_xy, jz_ratio * j_xy], -1)
    t2w = _uniform(g, (n,), *c["thrust_to_weight"])
    kappa = _uniform(g, (n,), *c["torque_constant_rel"]) * arm
    tau = _log_uniform(g, (n,), *c["motor_time_constant"])
    rpm_min = _uniform(g, (n,), *c["rpm_min"])
    s = 1.0 / math.sqrt(2.0)
    base = torch.tensor([[s, -s, 0.0], [-s, -s, 0.0], [-s, s, 0.0], [s, s, 0.0]], device=dev)
    jitter = torch.randn((n, 4, 3), generator=g, device=dev) * c["rotor_position_jitter"]
    rotor_pos = (base + jitter) * arm[:, None, None]
    tilt = torch.randn((n, 4, 2), generator=g, device=dev) * c["thrust_axis_tilt_std"]
    thrust_dir = torch.stack([
        torch.sin(tilt[..., 0]),
        torch.sin(tilt[..., 1]) * torch.cos(tilt[..., 0]),
        torch.cos(tilt[..., 1]) * torch.cos(tilt[..., 0]),
    ], -1)
    a_mix = _uniform(g, (n,), 0.0, c["thrust_curve_linear_mix_max"])
    t_max = t2w * mass * GRAVITY / 4.0
    thrust_curve = torch.stack([torch.zeros_like(a_mix), a_mix * t_max, (1.0 - a_mix) * t_max], -1)
    return dict(
        mass=mass, inertia=inertia, inertia_inv=1.0 / inertia, rotor_pos=rotor_pos,
        thrust_dir=thrust_dir,
        torque_sign=torch.tensor(ROTOR_TORQUE_SIGNS, device=dev).expand(n, 4),
        thrust_curve=thrust_curve, torque_constant=kappa, rpm_min=rpm_min,
        rpm_max=torch.ones(n, device=dev), motor_tau=tau,
    )


def repeat_envs(frames: Dict[str, torch.Tensor], per: int) -> Dict[str, torch.Tensor]:
    """Each airframe repeated over `per` consecutive envs."""
    return {k: v.repeat_interleave(per, 0) for k, v in frames.items()}


def hover_rpm(p) -> torch.Tensor:
    """Normalized rotor speed at hover: the positive root of T(u) = m g / 4."""
    c0, c1, c2 = p["thrust_curve"].unbind(-1)
    target = p["mass"] * GRAVITY / 4.0 - c0
    small2 = torch.abs(c2) < 1e-8
    c2s = torch.where(small2, torch.full_like(c2, 1e-8), c2)
    disc = torch.sqrt(torch.clamp(c1 * c1 + 4.0 * c2s * target, min=0.0))
    u_lin = target / torch.where(torch.abs(c1) < 1e-8, torch.full_like(c1, 1e-8), c1)
    return torch.clamp(torch.where(small2, u_lin, (-c1 + disc) / (2.0 * c2s)), 0.0, 1.0)


def hover_action(p) -> torch.Tensor:
    span = torch.clamp(p["rpm_max"] - p["rpm_min"], min=1e-6)
    return torch.clamp(2.0 * (hover_rpm(p) - p["rpm_min"]) / span - 1.0, -1.0, 1.0)


def sample_states(p, g: torch.Generator, init: dict) -> Dict[str, torch.Tensor]:
    """Initial states: uniform position box, attitude up to max_angle about a
    uniform axis, Gaussian velocities, rotors at hover speed."""
    n, dev = p["mass"].shape[0], g.device
    r = init["position_range"]
    pos = -r + torch.rand((n, 3), generator=g, device=dev) * (2.0 * r)
    axis = torch.randn((n, 3), generator=g, device=dev)
    axis = axis * torch.rsqrt(torch.sum(axis * axis, -1, keepdim=True) + 1e-12)
    u = torch.rand((n,), generator=g, device=dev)
    if init["angle_power"] != 1.0:
        u = u ** (1.0 / init["angle_power"])
    half = 0.5 * u * init["max_angle"]
    q = torch.cat([torch.cos(half)[:, None], torch.sin(half)[:, None] * axis], -1)
    v = torch.randn((n, 3), generator=g, device=dev) * init["linear_velocity_std"]
    w = torch.randn((n, 3), generator=g, device=dev) * init["angular_velocity_std"]
    rpm = hover_rpm(p)[:, None].expand(n, 4)
    return dict(p=pos, q=q, v=v, w=w, rpm=rpm)


def to_rows(tree: Dict[str, torch.Tensor], layout) -> torch.Tensor:
    """A dict of [N, ...] tensors -> the [rows, N] structure of arrays."""
    n = tree[layout[0][0]].shape[0]
    return torch.cat([tree[k].reshape(n, width).T for k, width in layout])


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def _rotate(q, v):
    """Body vector -> world frame by the unit quaternion (w, x, y, z)."""
    t = 2.0 * _cross(q[..., 1:], v)
    return v + q[..., :1] * t + _cross(q[..., 1:], t)


def _quat_derivative(q, w):
    qw, qx, qy, qz = q.unbind(-1)
    wx, wy, wz = w.unbind(-1)
    return 0.5 * torch.stack([
        -qx * wx - qy * wy - qz * wz,
        qw * wx + qy * wz - qz * wy,
        qw * wy - qx * wz + qz * wx,
        qw * wz + qx * wy - qy * wx,
    ], -1)


def _derivative(p, s, setpoint, ext_f=None, ext_t=None):
    c = p["thrust_curve"]
    thrust = c[:, 0:1] + c[:, 1:2] * s["rpm"] + c[:, 2:3] * s["rpm"] * s["rpm"]
    f_rotors = thrust[..., None] * p["thrust_dir"]
    force = f_rotors.sum(1)
    torque = _cross(p["rotor_pos"], f_rotors).sum(1) + (
        (p["torque_sign"] * p["torque_constant"][:, None] * thrust)[..., None] * p["thrust_dir"]
    ).sum(1)
    world = _rotate(s["q"], force)
    if ext_f is not None:
        torque, world = torque + ext_t, world + ext_f
    accel = world / p["mass"][:, None]
    accel = torch.cat([accel[:, :2], accel[:, 2:] - GRAVITY], -1)
    j, w = p["inertia"], s["w"]
    return dict(
        p=s["v"], q=_quat_derivative(s["q"], w), v=accel,
        w=p["inertia_inv"] * (torque - _cross(w, j * w)),
        rpm=(setpoint - s["rpm"]) / p["motor_tau"][:, None],
    )


def _axpy(s, d, h):
    return {k: s[k] + h * d[k] for k in s}


def rk4_step(p, s, action, dt, ext_f=None, ext_t=None):
    """One control step: rpm setpoint from the clipped action, RK4 (with a
    world-frame force and a body-frame torque held over the step, where
    given), quaternion renormalized, rotor speed clipped to [0, rpm_max]."""
    a = torch.clamp(action, -1.0, 1.0)
    lo, hi = p["rpm_min"][:, None], p["rpm_max"][:, None]
    setpoint = lo + (a + 1.0) * 0.5 * (hi - lo)
    k1 = _derivative(p, s, setpoint, ext_f, ext_t)
    k2 = _derivative(p, _axpy(s, k1, 0.5 * dt), setpoint, ext_f, ext_t)
    k3 = _derivative(p, _axpy(s, k2, 0.5 * dt), setpoint, ext_f, ext_t)
    k4 = _derivative(p, _axpy(s, k3, dt), setpoint, ext_f, ext_t)
    nxt = {k: s[k] + (dt / 6.0) * (k1[k] + 2.0 * k2[k] + 2.0 * k3[k] + k4[k]) for k in s}
    nxt["q"] = nxt["q"] * torch.rsqrt(torch.sum(nxt["q"] ** 2, -1, keepdim=True))
    nxt["rpm"] = torch.minimum(torch.clamp(nxt["rpm"], min=0.0), hi)
    return nxt


def rotation_matrix(q):
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], -1)


def observe(s, prev_action):
    """The 22-value policy observation."""
    return torch.cat([s["p"], rotation_matrix(s["q"]), s["v"], s["w"], prev_action], -1)


def privileged_tail(p):
    """The critics' 9 normalized airframe parameters."""
    c = p["thrust_curve"]
    rpm = p["rpm_max"][:, None]
    t2w = (c[:, 0:1] + c[:, 1:2] * rpm + c[:, 2:3] * rpm * rpm).expand(-1, 4).sum(-1) / (
        p["mass"] * GRAVITY)
    arm = torch.linalg.norm(p["rotor_pos"], dim=-1).mean(-1)
    return torch.stack([
        torch.log(p["mass"] / 0.25), torch.log(p["inertia"][:, 0] / 1e-3),
        torch.log(p["inertia"][:, 2] / 1e-3), t2w / 4.0, p["torque_constant"] / 0.05,
        torch.log(p["motor_tau"] / 0.05), p["rpm_min"], arm / 0.25, hover_action(p),
    ], -1)


def reward(p, s_next, action, rc: dict):
    cost = (
        rc["position_weight"] * torch.sum(s_next["p"] ** 2, -1)
        + rc["orientation_weight"] * 2.0 * (1.0 - torch.abs(s_next["q"][:, 0]))
        + rc["linear_velocity_weight"] * torch.sum(s_next["v"] ** 2, -1)
        + rc["angular_velocity_weight"] * torch.sum(s_next["w"] ** 2, -1)
        + rc["action_weight"] * torch.sum((action - hover_action(p)[:, None]) ** 2, -1)
    )
    return rc["scale"] * (rc["constant"] - cost)


def terminated(s, tc: dict):
    return (
        torch.any(torch.abs(s["p"]) > tc["position_bound"], -1)
        | (torch.sum(s["v"] ** 2, -1) > tc["linear_velocity_bound"] ** 2)
        | (torch.sum(s["w"] ** 2, -1) > tc["angular_velocity_bound"] ** 2)
        | ~torch.all(torch.isfinite(s["p"]), -1)
    )


def policy_step(w: Dict[str, torch.Tensor], h, obs, precision: str = "float32"):
    """Dense(22->H, ReLU) -> GRU(H; gates r, z, n) -> Dense(H->4)."""
    n_h = h.shape[-1]
    x = torch.relu(matmul(obs, w["dense_0/weights"].T, precision) + w["dense_0/biases"])
    gi = matmul(x, w["gru_1/weights_input"].T, precision) + w["gru_1/biases_input"]
    gh = matmul(h, w["gru_1/weights_hidden"].T, precision) + w["gru_1/biases_hidden"]
    r = torch.sigmoid(gi[:, :n_h] + gh[:, :n_h])
    z = torch.sigmoid(gi[:, n_h:2 * n_h] + gh[:, n_h:2 * n_h])
    cand = torch.tanh(gi[:, 2 * n_h:] + r * gh[:, 2 * n_h:])
    h_new = (1.0 - z) * cand + z * h
    return h_new, matmul(h_new, w["dense_2/weights"].T, precision) + w["dense_2/biases"]


@torch.no_grad()
def closed_loop(w, p, s, n_steps: int, env: dict, precision: str = "float32"
                ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor, torch.Tensor, torch.Tensor]:
    """Whole episodes of the policy's clipped action from the states `s`:
    (final state, alive, length, return), each env to termination or the
    cap. A terminated env keeps its last state before termination and earns
    nothing more; reward and length accrue while it is alive at the start of
    a step."""
    n = p["mass"].shape[0]
    h = w["gru_1/initial_hidden_state"].expand(n, -1)
    prev = s["p"].new_zeros((n, 4))
    alive = torch.ones(n, dtype=torch.bool, device=s["p"].device)
    length = torch.zeros(n, device=s["p"].device)
    ret = torch.zeros(n, device=s["p"].device)
    for _ in range(n_steps):
        h_new, action = policy_step(w, h, observe(s, prev), precision)
        action = torch.clamp(action, -1.0, 1.0)
        s2 = rk4_step(p, s, action, env["dt"])
        ret = torch.where(alive, ret + reward(p, s2, action, env["reward"]), ret)
        length = length + alive
        alive = alive & ~terminated(s2, env["termination"])
        keep = alive[:, None]
        s = {k: torch.where(keep, s2[k], s[k]) for k in s}
        h = torch.where(keep, h_new, h)
        prev = torch.where(keep, action, prev)
    return s, alive, length, ret


def summarize(ret, length, alive) -> torch.Tensor:
    """[return mean, return std, length mean, length std, share terminated]."""
    return torch.stack([
        ret.mean(), ret.std(correction=0), length.mean(), length.std(correction=0),
        (~alive).float().mean(),
    ])
