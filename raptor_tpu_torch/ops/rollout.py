"""Fused constant-action RK4 rollout: T steps of N airframes in one CUDA
kernel (`csrc/rollout.cu`).

Counterpart of `raptor_tpu/ops/pallas_rollout.py`. Layouts (no padding; the
kernel masks the ragged edge):
  params [42, N]  mass J(3) Jinv(3) rotor_pos(12) thrust_dir(12)
                  torque_sign(4) thrust_curve(3) kappa rpm_min rpm_max T_m
  state  [17, N]  p(3) q(4) v(3) w(3, body) rpm(4)
  action [4, N]   held constant over the rollout
Dead envs (the full `env.quad.terminated` predicate) freeze to their pre-step
state; the step they die on counts toward their length.

`rollout_soa` is the kernel's wrapper: a CUDA tensor launches the kernel (or
raises), a CPU tensor takes `rollout_plain`, the same function in plain
PyTorch. Each launch counts in `utils.profiling.launches`. The kernel
flies each env on a team of lanes (`threads_per_env()`).
"""

from __future__ import annotations

from typing import Tuple

import torch

from raptor_tpu_torch.device import resolve_device
from raptor_tpu_torch.env import dynamics
from raptor_tpu_torch.env.quad import terminated_by
from raptor_tpu_torch.env.types import N_PARAM, N_STATE, DynamicsParams, State, where
from raptor_tpu_torch.ops import build
from raptor_tpu_torch.utils.profiling import launches


def check_tensor(name: str, t: torch.Tensor, shape: tuple, device: torch.device) -> None:
    """Raise unless `t` is a contiguous f32 tensor of `shape` on `device`."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def threads_per_env() -> int:
    """Lanes of a team that fly one env in the rollout kernel (builds it)."""
    return build.cuda_library().raptor_rollout_threads_per_env()


def rollout_plain(
    params_soa: torch.Tensor,
    state_soa: torch.Tensor,
    action_soa: torch.Tensor,
    n_steps: int,
    dt: float = 0.01,
    pos_bound: float = 0.6,
    linvel_bound: float = 1000.0,
    angvel_bound: float = 35.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The rollout in plain PyTorch on `env.dynamics`: returns
    (state [17, N], stats [2, N] = alive, length)."""
    params = DynamicsParams.from_soa(params_soa)
    state = State.from_soa(state_soa)
    setpoint = dynamics.action_to_rpm_setpoint(params, action_soa.T)
    zeros = torch.zeros_like(state.position)
    alive = torch.ones_like(params.mass, dtype=torch.bool)
    length = torch.zeros_like(params.mass)
    for _ in range(n_steps):
        nxt = dynamics.integrate(params, state, setpoint, dt, zeros, zeros)
        length = length + alive
        alive = alive & ~terminated_by(nxt, pos_bound, linvel_bound, angvel_bound)
        state = where(alive, nxt, state)
    return state.to_soa(), torch.stack([alive.float(), length])


def rollout_soa(
    params_soa: torch.Tensor,
    state_soa: torch.Tensor,
    action_soa: torch.Tensor,
    n_steps: int,
    dt: float = 0.01,
    pos_bound: float = 0.6,
    linvel_bound: float = 1000.0,
    angvel_bound: float = 35.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's wrapper: (params [42, N], state [17, N], action [4, N]) ->
    (state [17, N], stats [2, N] = alive, length). Does not synchronize."""
    device, n = state_soa.device, state_soa.shape[-1]
    check_tensor("params", params_soa, (N_PARAM, n), device)
    check_tensor("state", state_soa, (N_STATE, n), device)
    check_tensor("action", action_soa, (4, n), device)
    if device.type == "cpu":
        return rollout_plain(
            params_soa, state_soa, action_soa, n_steps, dt, pos_bound, linvel_bound,
            angvel_bound,
        )
    if device.type != "cuda":
        raise ValueError(f"no rollout kernel for device {device}")
    lib = build.cuda_library()
    out = torch.empty_like(state_soa)
    stats = torch.empty((2, n), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        rc = lib.raptor_rollout(
            params_soa.data_ptr(), state_soa.data_ptr(), action_soa.data_ptr(),
            out.data_ptr(), stats.data_ptr(), n, int(n_steps), dt, pos_bound,
            linvel_bound, angvel_bound, torch.cuda.current_stream(device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"raptor_rollout launch failed: CUDA error {rc}")
    launches["rollout"] += 1
    return out, stats


def fused_rollout(
    params: DynamicsParams,
    state: State,
    action: torch.Tensor,  # [N, 4] constant action
    n_steps: int,
    dt: float = 0.01,
    pos_bound: float = 0.6,
    angvel_bound: float = 35.0,
    linvel_bound: float = 1000.0,
    device="cuda",
) -> Tuple[State, torch.Tensor, torch.Tensor]:
    """[N]-batched airframes, states and actions -> (State, alive [N],
    length [N]) after n_steps, on `device`."""
    device = resolve_device(device)
    out, stats = rollout_soa(
        params.to_soa().to(device),
        state.to_soa().to(device),
        action.T.contiguous().to(device, torch.float32),
        n_steps, dt, pos_bound, linvel_bound, angvel_bound,
    )
    return State.from_soa(out), stats[0], stats[1]
