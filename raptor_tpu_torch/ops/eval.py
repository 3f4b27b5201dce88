"""Fused closed-loop policy evaluation: whole episodes of obs -> Dense -> GRU
-> Dense -> clip -> RK4 -> reward -> termination for N airframes in one CUDA
kernel (`csrc/eval.cu`).

Counterpart of `raptor_tpu/ops/pallas_eval.py`, with two differences:
- the 2,084 policy weights are an input (the flat layout of `flatten_policy`)
  instead of constants baked into the kernel, so one build serves every
  checkpoint;
- termination is the full `env.quad.terminated` predicate (the Pallas kernel
  leaves out the linear-velocity bound, off at its 1000 m/s default, and the
  non-finite check), and a dead env freezes by a select, so a non-finite
  state cannot spread.
A terminated env keeps its pre-step state, hidden state and previous action;
reward and length accrue while the env is alive at step start.

`eval_soa` is the kernel's wrapper: a CUDA tensor launches the kernel (or
raises), a CPU tensor takes `eval_plain`. `launches` counts kernel launches.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from raptor_tpu_torch.device import resolve_device
from raptor_tpu_torch.env import dynamics
from raptor_tpu_torch.env.quad import L2F
from raptor_tpu_torch.env.types import (
    N_PARAM,
    N_STATE,
    DynamicsParams,
    EnvConfig,
    ObservationConfig,
    RewardConfig,
    State,
    TerminationConfig,
    where,
)
from raptor_tpu_torch.ops import build
from raptor_tpu_torch.ops.rollout import check_tensor
from raptor_tpu_torch.policy import network

launches = 0

HIDDEN, OBS = network.HIDDEN_DIM, network.OBS_DIM
# flat policy layout (raptor_tpu/ops/pallas_collect.py:85-116), in order
_LAYOUT = (
    ("dense_0", "weights", (HIDDEN, OBS)),
    ("dense_0", "biases", (HIDDEN,)),
    ("gru_1", "weights_input", (3 * HIDDEN, HIDDEN)),
    ("gru_1", "weights_hidden", (3 * HIDDEN, HIDDEN)),
    ("gru_1", "biases_input", (3 * HIDDEN,)),
    ("gru_1", "biases_hidden", (3 * HIDDEN,)),
    ("gru_1", "initial_hidden_state", (HIDDEN,)),
    ("dense_2", "weights", (network.ACTION_DIM, HIDDEN)),
    ("dense_2", "biases", (network.ACTION_DIM,)),
)
N_WEIGHTS = sum(torch.Size(shape).numel() for _, _, shape in _LAYOUT)  # 2084


def flatten_policy(policy_params: network.Params) -> torch.Tensor:
    """Policy dict -> one f32 [2084] vector: w0 . b0 . wi . wh . bi . bh . h0
    . w2 . b2."""
    parts = []
    for layer, name, shape in _LAYOUT:
        t = policy_params[layer][name]
        if tuple(t.shape) != shape:
            raise ValueError(f"{layer}/{name} has shape {tuple(t.shape)}, expected {shape}")
        parts.append(t.reshape(-1).float())
    return torch.cat(parts).contiguous()


def unflatten_policy(weights: torch.Tensor) -> network.Params:
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    off = 0
    for layer, name, shape in _LAYOUT:
        size = torch.Size(shape).numel()
        out.setdefault(layer, {})[name] = weights[off : off + size].reshape(shape)
        off += size
    return out


def _reward_args(rc: RewardConfig):
    return (
        rc.scale, rc.constant, rc.position_weight, rc.orientation_weight,
        rc.linear_velocity_weight, rc.angular_velocity_weight, rc.action_weight,
    )


def eval_plain(
    policy_params: network.Params,
    params_soa: torch.Tensor,
    state_soa: torch.Tensor,
    n_steps: int,
    dt: float = 0.01,
    pos_bound: float = 0.6,
    linvel_bound: float = 1000.0,
    angvel_bound: float = 35.0,
    reward_config: RewardConfig = RewardConfig(),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The evaluation in plain PyTorch on `env` and `policy.network`: returns
    (state [17, N], stats [3, N] = alive, length, return)."""
    env = L2F(
        EnvConfig(
            dt=dt,
            reward=reward_config,
            termination=TerminationConfig(pos_bound, linvel_bound, angvel_bound),
            observation=ObservationConfig(privileged=False),
        )
    )
    params = DynamicsParams.from_soa(params_soa)
    s = State.from_soa(state_soa)
    n = params.mass.shape[0]
    zeros = torch.zeros_like(s.position)
    h = network.initial_hidden(policy_params, n)
    prev = s.position.new_zeros((n, 4))
    alive = torch.ones_like(params.mass, dtype=torch.bool)
    length = torch.zeros_like(params.mass)
    ret = torch.zeros_like(params.mass)
    for _ in range(n_steps):
        obs = env.observe(params, s, prev)
        h_new, action = network.apply_step(policy_params, h, obs)
        action = torch.clamp(action, -1.0, 1.0)
        setpoint = dynamics.action_to_rpm_setpoint(params, action)
        s2 = dynamics.integrate(params, s, setpoint, dt, zeros, zeros)
        ret = torch.where(alive, ret + env.reward(params, s, action, s2), ret)
        length = length + alive
        alive = alive & ~env.terminated(params, s2)
        s = where(alive, s2, s)
        h = where(alive, h_new, h)
        prev = where(alive, action, prev)
    return s.to_soa(), torch.stack([alive.float(), length, ret])


def eval_soa(
    weights: torch.Tensor,
    params_soa: torch.Tensor,
    state_soa: torch.Tensor,
    n_steps: int,
    dt: float = 0.01,
    pos_bound: float = 0.6,
    linvel_bound: float = 1000.0,
    angvel_bound: float = 35.0,
    reward_config: RewardConfig = RewardConfig(),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's wrapper: (weights [2084], params [42, N], state [17, N])
    -> (state [17, N], stats [3, N] = alive, length, return). Does not
    synchronize."""
    global launches
    device, n = state_soa.device, state_soa.shape[-1]
    check_tensor("weights", weights, (N_WEIGHTS,), device)
    check_tensor("params", params_soa, (N_PARAM, n), device)
    check_tensor("state", state_soa, (N_STATE, n), device)
    if device.type == "cpu":
        return eval_plain(
            unflatten_policy(weights), params_soa, state_soa, n_steps, dt, pos_bound,
            linvel_bound, angvel_bound, reward_config,
        )
    if device.type != "cuda":
        raise ValueError(f"no eval kernel for device {device}")
    lib = build.cuda_library()
    out = torch.empty_like(state_soa)
    stats = torch.empty((3, n), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        rc = lib.raptor_eval(
            weights.data_ptr(), params_soa.data_ptr(), state_soa.data_ptr(),
            out.data_ptr(), stats.data_ptr(), n, int(n_steps), dt, pos_bound,
            linvel_bound, angvel_bound, *_reward_args(reward_config),
            torch.cuda.current_stream(device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"raptor_eval launch failed: CUDA error {rc}")
    launches += 1
    return out, stats


def make_fused_policy_eval(
    policy_params: network.Params,
    n_steps: int,
    dt: float = 0.01,
    pos_bound: float = 0.6,
    angvel_bound: float = 35.0,
    reward_config: RewardConfig = RewardConfig(),
    linvel_bound: float = 1000.0,
    device="cuda",
):
    """An evaluator for one checkpoint: fn(params [N], state [N]) ->
    (final State, alive [N], length [N], return [N]) on `device`. The weights
    are flattened and moved to the device once."""
    device = resolve_device(device)
    weights = flatten_policy(policy_params).to(device)

    def run(params: DynamicsParams, state: State):
        out, stats = eval_soa(
            weights, params.to_soa().to(device), state.to_soa().to(device), n_steps,
            dt, pos_bound, linvel_bound, angvel_bound, reward_config,
        )
        return State.from_soa(out), stats[0], stats[1], stats[2]

    return run


def fused_policy_eval(
    policy_params: network.Params,
    params: DynamicsParams,
    state: State,
    n_steps: int,
    dt: float = 0.01,
    pos_bound: float = 0.6,
    angvel_bound: float = 35.0,
    reward_config: RewardConfig = RewardConfig(),
    linvel_bound: float = 1000.0,
    device="cuda",
):
    """One-shot `make_fused_policy_eval(...)(params, state)`."""
    run = make_fused_policy_eval(
        policy_params, n_steps, dt, pos_bound, angvel_bound, reward_config,
        linvel_bound, device,
    )
    return run(params, state)
