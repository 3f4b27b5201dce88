"""Fused DAgger-collect rollout: T closed-loop steps of the student policy over
N airframes with in-kernel episode auto-reset, in one CUDA kernel
(`csrc/collect.cu`), streaming every visited observation and the done flag.

Counterpart of `raptor_tpu/ops/pallas_collect.py`. Row t of the output holds
the observation before step t and the done flag after it. On done (the full
`env.quad.terminated` predicate, or the env's own step count reaching
`episode_length`) the env restarts from a fresh initial state, the hidden
state from the learned h0, the previous action from 0. Fresh states come from
a counter-hash PRNG (lowbias32) keyed by (seed, env id, step): the integer
stream and the uniforms equal the JAX functions bit for bit, the normals to a
few ulp of logf/sqrtf/cosf/sinf. `env_offset` is added to the env ids, so a
population split over several launches (or devices) draws the stream of the
whole. Dynamics are deterministic: the per-step disturbance forces of
`L2F.dynamics_step` are not modelled. Teacher labels are not computed here;
`distill.post_training.make_relabel` adds them in one batched pass.

The kernel flies each env on a team of `COLLECT_TEAM` lanes of one warp
(`csrc/team_step.cuh` `team_collect_env`, over the eval kernel's physics and
split GRU): the policy is split by hidden unit, the rotors by lane, each lane
stores its share of the observation channels, and the done flag and the
reset are the team's, from lane 0. `threads_per_env` reads the team's size
from the build.

`collect_soa` is the kernel's wrapper: a CUDA tensor launches the kernel (or
raises), a CPU tensor takes `collect_plain`, the same function in plain
PyTorch. Each launch counts in `utils.profiling.launches`. The kernel is
built for 22 observations and the hidden widths of `ops.eval.HIDDEN_WIDTHS`;
another width raises `ValueError` and is collected by
`distill.post_training.make_collect`.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from raptor_tpu_torch.device import resolve_device
from raptor_tpu_torch.env import dynamics, maths
from raptor_tpu_torch.env.quad import L2F
from raptor_tpu_torch.env.types import (
    N_PARAM,
    N_STATE,
    DynamicsParams,
    EnvConfig,
    InitConfig,
    State,
    where,
)
from raptor_tpu_torch.ops import build
from raptor_tpu_torch.ops.eval import (
    check_hidden_width,
    flatten_policy,
    hidden_width,
    n_weights,
    require_built,
    unflatten_policy,
)
from raptor_tpu_torch.ops.rollout import check_tensor
from raptor_tpu_torch.policy import network
from raptor_tpu_torch.utils.profiling import launches

OBS_CH = network.OBS_DIM  # policy observation channels recorded
OUT_CH = OBS_CH + 1  # + the done flag

_M32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# the kernel's PRNG in plain PyTorch. uint32 arithmetic is not available on
# every backend, so counters are int64 tensors holding values below 2^32 and
# every product is wrapped explicitly.
# ---------------------------------------------------------------------------


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 without leaving the int64 range."""
    lo = x * (c & 0xFFFF)
    hi = (x * (c >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def lowbias32(x: torch.Tensor) -> torch.Tensor:
    """The lowbias32 integer hash on int64 tensors holding uint32 values."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def uniform01(ctr: torch.Tensor, draw: int) -> torch.Tensor:
    """U(0, 1) f32 from a counter tensor and a draw id: 24 mantissa-exact
    bits plus half a step, so log() stays finite."""
    bits = lowbias32((ctr + ((0x9E3779B9 * draw) & _M32)) & _M32)
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24)) + (0.5 / (1 << 24))


def normal_pair(ctr: torch.Tensor, draw: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two N(0, 1) tensors (Box-Muller) from draws `draw` and `draw + 1`."""
    u1, u2 = uniform01(ctr, draw), uniform01(ctr, draw + 1)
    r = torch.sqrt(-2.0 * torch.log(u1))
    th = (2.0 * math.pi) * u2
    return r * torch.cos(th), r * torch.sin(th)


def reset_counter(env_id: torch.Tensor, seed: int, t: int) -> torch.Tensor:
    """Per-step counters of envs `env_id` (int64) at absolute step t."""
    mix = ((seed * 0x85EBCA6B) & _M32) ^ ((t * 0xC2B2AE35) & _M32)
    return _mul32(lowbias32(env_id ^ mix), 31)


def sample_state(params: DynamicsParams, ctr: torch.Tensor, init: InitConfig) -> State:
    """Fresh initial states from counters [N]: the kernel's sampler (draw ids
    0-2 position, 3-6 axis, 7 angle, 8-13 velocities)."""
    pos = torch.stack([(uniform01(ctr, d) * 2.0 - 1.0) * init.position_range for d in range(3)], -1)
    ax, ay = normal_pair(ctr, 3)
    az, _ = normal_pair(ctr, 5)
    inv = 1.0 / torch.sqrt(ax * ax + ay * ay + az * az + 1e-12)
    u_angle = uniform01(ctr, 7)
    if init.angle_power != 1.0:
        u_angle = torch.exp(torch.log(u_angle) * (1.0 / init.angle_power))
    half = u_angle * init.max_angle * 0.5
    s, c = torch.sin(half), torch.cos(half)
    v1, v2 = normal_pair(ctr, 8)
    v3, w1 = normal_pair(ctr, 10)
    w2, w3 = normal_pair(ctr, 12)
    rpm = dynamics.hover_rpm(params) if init.rpm_at_hover else params.rpm_min
    return State(
        position=pos,
        orientation=torch.stack([c, ax * inv * s, ay * inv * s, az * inv * s], -1),
        linear_velocity=torch.stack([v1, v2, v3], -1) * init.linear_velocity_std,
        angular_velocity=torch.stack([w1, w2, w3], -1) * init.angular_velocity_std,
        rpm=rpm[:, None].expand(-1, 4),
    )


# ---------------------------------------------------------------------------
# plain version and wrapper
# ---------------------------------------------------------------------------


def _check_config(config: EnvConfig) -> None:
    if config.observation.action_history_length != 1:
        raise ValueError("fused collect needs action_history_length == 1")
    if config.observation.angular_velocity_delay != 0:
        raise ValueError("fused collect needs angular_velocity_delay == 0")
    if config.integrator != "rk4":
        raise ValueError("fused collect integrates with RK4 only")


@torch.no_grad()
def collect_plain(
    policy_params: network.Params,
    params_soa: torch.Tensor,
    state_soa: torch.Tensor,
    n_steps: int,
    seed: int,
    env_offset: int = 0,
    config: EnvConfig = EnvConfig(),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The collect rollout in plain PyTorch on `env` and `policy.network`,
    with the kernel's PRNG: returns (obs [T, N, 22], reset [T, N])."""
    _check_config(config)
    env = L2F(config)
    params = DynamicsParams.from_soa(params_soa)
    s = State.from_soa(state_soa)
    n = params.mass.shape[0]
    zeros = torch.zeros_like(s.position)
    h0 = network.initial_hidden(policy_params, n)
    h = h0
    prev = s.position.new_zeros((n, 4))
    tcount = torch.zeros_like(params.mass)
    env_id = (torch.arange(n, device=params_soa.device, dtype=torch.int64) + env_offset) & _M32
    obs_rows, reset_rows = [], []
    for t in range(n_steps):
        obs = torch.cat(
            [s.position, maths.quat_to_rotm(s.orientation).reshape(n, 9), s.linear_velocity,
             s.angular_velocity, prev], -1)
        h_new, action = network.apply_step(policy_params, h, obs)
        action = torch.clamp(action, -1.0, 1.0)
        setpoint = dynamics.action_to_rpm_setpoint(params, action)
        s2 = dynamics.integrate(params, s, setpoint, config.dt, zeros, zeros)
        t2 = tcount + 1.0
        done = env.terminated(params, s2) | (t2 > config.episode_length - 0.5)
        obs_rows.append(obs)
        reset_rows.append(done.float())
        fresh = sample_state(params, reset_counter(env_id, seed, t), config.init)
        s = where(done, fresh, s2)  # a select: a non-finite s2 is replaced
        h = where(done, h0, h_new)
        prev = where(done, torch.zeros_like(action), action)
        tcount = torch.where(done, torch.zeros_like(t2), t2)
    return torch.stack(obs_rows), torch.stack(reset_rows)


def threads_per_env(hidden: int = network.HIDDEN_DIM) -> int:
    """Lanes of a team that fly one env in the collect kernel of this hidden
    width (builds it)."""
    require_built(hidden)
    return getattr(build.cuda_library(), f"raptor_collect_threads_per_env_{hidden}")()


def collect_soa(
    weights: torch.Tensor,
    params_soa: torch.Tensor,
    state_soa: torch.Tensor,
    n_steps: int,
    seed: int,
    env_offset: int = 0,
    config: EnvConfig = EnvConfig(),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's wrapper: (weights [n_weights(H)], params [42, N], state
    [17, N]) -> (obs [T, N, 22], reset [T, N]), H in HIDDEN_WIDTHS. On the
    card both are views of one channel-major [T, 23, N] buffer, allocated once
    per call; `.contiguous()` transposes obs where a caller needs it dense.
    Does not synchronize."""
    _check_config(config)
    device, n = state_soa.device, state_soa.shape[-1]
    hidden = hidden_width(weights)
    require_built(hidden)
    check_tensor("weights", weights, (n_weights(hidden),), device)
    check_tensor("params", params_soa, (N_PARAM, n), device)
    check_tensor("state", state_soa, (N_STATE, n), device)
    seed, env_offset = int(seed) & _M32, int(env_offset) & _M32
    if device.type == "cpu":
        return collect_plain(
            unflatten_policy(weights), params_soa, state_soa, n_steps, seed, env_offset, config
        )
    if device.type != "cuda":
        raise ValueError(f"no collect kernel for device {device}")
    lib = build.cuda_library()
    out = torch.empty((int(n_steps), OUT_CH, n), dtype=torch.float32, device=device)
    term, init = config.termination, config.init
    with torch.cuda.device(device):
        rc = getattr(lib, f"raptor_collect_{hidden}")(
            weights.data_ptr(), params_soa.data_ptr(), state_soa.data_ptr(), out.data_ptr(),
            n, int(n_steps), config.dt, float(config.episode_length), term.position_bound,
            term.linear_velocity_bound, term.angular_velocity_bound, init.position_range,
            init.max_angle, init.angle_power, init.linear_velocity_std,
            init.angular_velocity_std, int(init.rpm_at_hover), seed, env_offset,
            torch.cuda.current_stream(device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"raptor_collect launch failed: CUDA error {rc}")
    launches["collect"] += 1
    return out[:, :OBS_CH].permute(0, 2, 1), out[:, OBS_CH]


def make_fused_collect(
    student_params: network.Params,
    n_steps: int,
    config: EnvConfig = EnvConfig(),
    device="cuda",
):
    """Fused collect for one student checkpoint: fn(params [N], state0 [N],
    seed, env_offset=0) -> (obs [T, N, 22], reset [T, N]) on `device`. The
    weights are flattened (detached) and moved to the device once; one build
    of the kernel serves every round's student."""
    device = resolve_device(device)
    _check_config(config)
    check_hidden_width(student_params)
    weights = flatten_policy(student_params).detach().to(device)

    def run(params: DynamicsParams, state0: State, seed, env_offset=0):
        return collect_soa(
            weights, params.to_soa().to(device), state0.to_soa().to(device), n_steps,
            int(seed), int(env_offset), config,
        )

    return run


def fused_collect(
    student_params: network.Params,
    params: DynamicsParams,
    state0: State,
    n_steps: int,
    seed,
    env_offset=0,
    config: EnvConfig = EnvConfig(),
    device="cuda",
):
    """One-shot `make_fused_collect(...)(params, state0, seed, env_offset)`."""
    return make_fused_collect(student_params, n_steps, config, device)(
        params, state0, seed, env_offset
    )
