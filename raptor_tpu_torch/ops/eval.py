"""Fused closed-loop policy evaluation: whole episodes of obs -> Dense -> GRU
-> Dense -> clip -> RK4 -> reward -> termination for N airframes in one CUDA
kernel (`csrc/eval.cu`).

Counterpart of `raptor_tpu/ops/pallas_eval.py`, with two differences:
- the policy weights are an input (the flat layout of `flatten_policy`,
  2,084 floats at hidden width 16) instead of constants baked into the kernel,
  so one build serves every checkpoint of a width in `HIDDEN_WIDTHS`; another
  width raises `ValueError` and is served by `eval_plain` or the eager
  `rl.evaluation` loop;
- termination is the full `env.quad.terminated` predicate (the Pallas kernel
  leaves out the linear-velocity bound, off at its 1000 m/s default, and the
  non-finite check), and a dead env freezes by a select, so a non-finite
  state cannot spread.
A terminated env keeps its pre-step state, hidden state and previous action;
reward and length accrue while the env is alive at step start.

`eval_soa` is the kernel's wrapper: a CUDA tensor launches the kernel (or
raises), a CPU tensor takes `eval_plain`. Each launch counts in
`utils.profiling.launches`.
The kernel flies `envs_per_team()` envs on each team of `lanes_per_team()`
lanes, `threads_per_env()` lanes an env.
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
from raptor_tpu_torch.utils.profiling import launches, span

HIDDEN_WIDTHS = build.HIDDEN_WIDTHS  # the hidden widths the kernels are built for
OBS, ACT = network.OBS_DIM, network.ACTION_DIM


def layout(hidden: int):
    """(layer, name, shape) of the flat policy layout of a hidden width
    (raptor_tpu/ops/pallas_collect.py:85-116), in order."""
    return (
        ("dense_0", "weights", (hidden, OBS)),
        ("dense_0", "biases", (hidden,)),
        ("gru_1", "weights_input", (3 * hidden, hidden)),
        ("gru_1", "weights_hidden", (3 * hidden, hidden)),
        ("gru_1", "biases_input", (3 * hidden,)),
        ("gru_1", "biases_hidden", (3 * hidden,)),
        ("gru_1", "initial_hidden_state", (hidden,)),
        ("dense_2", "weights", (ACT, hidden)),
        ("dense_2", "biases", (ACT,)),
    )


def n_weights(hidden: int) -> int:
    """Floats of the flat layout of a hidden width: 2,084 at 16."""
    return 6 * hidden * hidden + (OBS + 1 + 6 + 1 + ACT) * hidden + ACT


def hidden_width(weights: torch.Tensor) -> int:
    """The hidden width of a flat weight vector, from its length."""
    n = weights.numel()
    hidden = round((-(OBS + 12) + ((OBS + 12) ** 2 + 24 * (n - ACT)) ** 0.5) / 12)
    if weights.dim() != 1 or hidden < 1 or n_weights(hidden) != n:
        raise ValueError(f"weights of shape {tuple(weights.shape)} are no flat policy layout")
    return hidden


def check_hidden_width(policy_params: network.Params) -> int:
    """The policy's hidden width; raises ValueError unless the kernels are
    built for it (Dense(22->H) -> GRU(H) -> Dense(H->4), H in HIDDEN_WIDTHS)."""
    hidden = policy_params["gru_1"]["initial_hidden_state"].shape[-1]
    require_built(hidden, policy_params["dense_0"]["weights"].shape[-1])
    return hidden


def require_built(hidden: int, obs_dim: int = OBS, kernels: str = "eval and collect",
                  instead: str = "evaluate other widths with ops.eval.eval_plain or "
                                 "rl.evaluation, collect them with "
                                 "distill.post_training.make_collect") -> None:
    """Raise ValueError, naming the built widths and what to use `instead`,
    unless the `kernels` are built for this hidden width and observation
    width."""
    if hidden not in HIDDEN_WIDTHS or obs_dim != OBS:
        raise ValueError(
            f"the {kernels} kernels are built for hidden widths {HIDDEN_WIDTHS} and "
            f"{OBS} observations, got {hidden} and {obs_dim}; {instead}"
        )


def lanes_per_team(hidden: int = network.HIDDEN_DIM) -> int:
    """Lanes of a team of the eval kernel at a hidden width (builds it); the
    team flies `envs_per_team(hidden)` envs."""
    return getattr(build.cuda_library(), f"raptor_eval_lanes_{hidden}")()


def threads_per_env(hidden: int = network.HIDDEN_DIM) -> int:
    """Lanes of the eval kernel that fly one env's physics at a hidden width
    (builds it): a team's lanes over its envs."""
    return lanes_per_team(hidden) // envs_per_team(hidden)


def envs_per_team(hidden: int = network.HIDDEN_DIM) -> int:
    """Envs a team of the eval kernel flies at a hidden width (builds it):
    every weight a lane loads serves them all."""
    return getattr(build.cuda_library(), f"raptor_eval_envs_{hidden}")()


def ride_along_share(length: torch.Tensor, envs: int, lanes: int) -> float:
    """The waste of flying `envs` envs on each team of `lanes` lanes, from the
    kernel's output lengths [N]: the env-steps flown for envs already done
    (and for the empty slots past N) over the env-steps run. Team t flies
    envs t, t + ceil(N / envs), ...; with several envs a team, a warp's
    32 / lanes teams fly every step together, as long as its longest env.
    With one env a team, a team leaves the loop when its env is done."""
    if envs == 1:
        return 0.0
    n = length.numel()
    n_teams = -(-n // envs)
    per_warp = 32 // lanes
    n_warps = -(-n_teams // per_warp)
    slots = length.new_zeros(envs * n_teams)
    slots[:n] = length.reshape(-1)
    slots = torch.nn.functional.pad(slots.view(envs, n_teams), (0, n_warps * per_warp - n_teams))
    # slot (v, t) holds env t + v * n_teams; a row of `warps`, a warp's slots
    warps = slots.view(envs, n_warps, per_warp).permute(1, 0, 2).reshape(n_warps, -1)
    flown = warps.amax(1) * warps.shape[1]
    return float((flown - warps.sum(1)).sum() / length.sum())


def flatten_policy(policy_params: network.Params) -> torch.Tensor:
    """Policy dict -> one f32 vector in the flat layout: w0 . b0 . wi . wh .
    bi . bh . h0 . w2 . b2, of the width of its hidden state."""
    hidden = policy_params["gru_1"]["initial_hidden_state"].shape[-1]
    parts = []
    for layer, name, shape in layout(hidden):
        t = policy_params[layer][name]
        if tuple(t.shape) != shape:
            raise ValueError(f"{layer}/{name} has shape {tuple(t.shape)}, expected {shape}")
        parts.append(t.reshape(-1).float())
    return torch.cat(parts).contiguous()


def unflatten_policy(weights: torch.Tensor) -> network.Params:
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    off = 0
    for layer, name, shape in layout(hidden_width(weights)):
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
    """The kernel's wrapper: (weights [n_weights(H)], params [42, N], state
    [17, N]) -> (state [17, N], stats [3, N] = alive, length, return), H in
    HIDDEN_WIDTHS. Does not synchronize."""
    device, n = state_soa.device, state_soa.shape[-1]
    hidden = hidden_width(weights)
    require_built(hidden)
    check_tensor("weights", weights, (n_weights(hidden),), device)
    check_tensor("params", params_soa, (N_PARAM, n), device)
    check_tensor("state", state_soa, (N_STATE, n), device)
    if device.type == "cpu":
        with span("ops.eval.launch"):
            return eval_plain(
                unflatten_policy(weights), params_soa, state_soa, n_steps, dt, pos_bound,
                linvel_bound, angvel_bound, reward_config,
            )
    if device.type != "cuda":
        raise ValueError(f"no eval kernel for device {device}")
    lib = build.cuda_library()
    out = torch.empty_like(state_soa)
    stats = torch.empty((3, n), dtype=torch.float32, device=device)
    with torch.cuda.device(device), span("ops.eval.launch"):
        rc = getattr(lib, f"raptor_eval_{hidden}")(
            weights.data_ptr(), params_soa.data_ptr(), state_soa.data_ptr(),
            out.data_ptr(), stats.data_ptr(), n, int(n_steps), dt, pos_bound,
            linvel_bound, angvel_bound, *_reward_args(reward_config),
            torch.cuda.current_stream(device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"raptor_eval launch failed: CUDA error {rc}")
    launches["eval"] += 1
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
    are flattened and moved to the device once. Raises ValueError for a
    hidden width the kernel is not built for."""
    device = resolve_device(device)
    check_hidden_width(policy_params)
    with span("ops.eval.pack"):
        weights = flatten_policy(policy_params).to(device)

    def run(params: DynamicsParams, state: State):
        with span("ops.eval.pack"):
            params_soa, state_soa = params.to_soa().to(device), state.to_soa().to(device)
        out, stats = eval_soa(
            weights, params_soa, state_soa, n_steps,
            dt, pos_bound, linvel_bound, angvel_bound, reward_config,
        )
        with span("ops.eval.unpack"):
            final = State.from_soa(out)
        return final, stats[0], stats[1], stats[2]

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
