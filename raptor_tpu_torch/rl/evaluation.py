"""Deterministic evaluation rollouts — the reference's 5-stat contract.

Counterpart of `raptor_tpu/rl/evaluation.py`: run the policy's mean action on
M envs for one episode cap and report the mean and std of return and episode
length and the share of episodes terminated. This is the eager closed loop;
`ops.eval.fused_policy_eval` runs the same loop for the GRU policy in one
kernel.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from raptor_tpu_torch.env.quad import L2F
from raptor_tpu_torch.env.types import DynamicsParams, State, where
from raptor_tpu_torch.policy import network
from raptor_tpu_torch.rl import networks
from raptor_tpu_torch.utils.profiling import span


class EvalStats(NamedTuple):
    return_mean: torch.Tensor
    return_std: torch.Tensor
    episode_length_mean: torch.Tensor
    episode_length_std: torch.Tensor
    share_terminated: torch.Tensor


def run_episodes(
    env: L2F,
    params: DynamicsParams,  # [M] eval airframes
    state: State,  # [M] initial states
    policy_step: Callable,  # (carry, obs [M, D]) -> (carry, action [M, 4])
    policy_carry,
    generator: torch.Generator,
    episode_length: Optional[int] = None,
):
    """One evaluation pass from given initial states: per-episode (return,
    length, alive), each [M]. Each env runs to termination or the cap; a
    terminated env keeps the state it died in and earns nothing more."""
    t_max = episode_length or env.EPISODE_LENGTH
    m = params.mass.shape[0]
    zero_action = state.position.new_zeros((m, 4))
    obs = env.observe(params, state, zero_action)
    alive = torch.ones_like(params.mass, dtype=torch.bool)
    ret = torch.zeros_like(params.mass)
    length = torch.zeros(m, dtype=torch.int32, device=params.mass.device)
    carry = policy_carry
    for _ in range(t_max):
        carry, action = policy_step(carry, obs)
        action = torch.clamp(action, -1.0, 1.0)
        stepped, _ = env.dynamics_step(params, state, action, generator)
        # freeze dead envs: integrating a diverged state overflows f32
        next_state = where(alive, stepped, state)
        reward = env.reward(params, state, action, next_state)
        terminated = env.terminated(params, next_state)
        ret = torch.where(alive, ret + reward, ret)
        length = length + alive.int()
        alive = alive & ~terminated
        state = next_state
        obs = env.observe(params, next_state, action)
    return ret, length, alive


def evaluate_from(
    env: L2F,
    params: DynamicsParams,
    state: State,
    policy_step: Callable,
    policy_carry,
    generator: torch.Generator,
    episode_length: Optional[int] = None,
) -> EvalStats:
    """`run_episodes` from given initial states, summarized."""
    return summarize(*run_episodes(
        env, params, state, policy_step, policy_carry, generator, episode_length))


def summarize(ret: torch.Tensor, length: torch.Tensor, alive: torch.Tensor) -> EvalStats:
    """The 5 stats of per-episode return, length and alive flag [M], over the
    last axis: [K, M] inputs give one value per row."""
    with span("rl.summarize"):
        length_f = length.float()
        return EvalStats(
            return_mean=torch.mean(ret, -1),
            return_std=torch.std(ret, -1, correction=0),
            episode_length_mean=torch.mean(length_f, -1),
            episode_length_std=torch.std(length_f, -1, correction=0),
            share_terminated=torch.mean(1.0 - alive.float(), -1),
        )


def evaluate(
    env: L2F,
    params: DynamicsParams,
    policy_step: Callable,
    policy_carry,
    generator: torch.Generator,
    n_envs: int,
    episode_length: Optional[int] = None,
) -> EvalStats:
    """Reset n_envs envs on `params` ([n_envs]-batched) from `generator`, then
    `evaluate_from` those initial states."""
    if params.mass.shape[0] != n_envs:
        raise ValueError(f"params hold {params.mass.shape[0]} airframes, n_envs={n_envs}")
    es, _ = env.reset(params, generator)
    return evaluate_from(
        env, params, es.dynamics, policy_step, policy_carry, generator, episode_length
    )


def mlp_policy_step(actor_params, actor_obs_dim: Optional[int] = None):
    """(step fn, empty carry) for a feedforward SAC actor's mean action, on
    the first `actor_obs_dim` observation channels where given."""

    def step(carry, obs):
        o = obs if actor_obs_dim is None else obs[..., :actor_obs_dim]
        return carry, networks.actor_mean(actor_params, o)

    return step, ()


def gru_policy_step(policy_params: network.Params, batch_size: int):
    """(step fn, initial carry) for the recurrent foundation policy on
    obs[:, :22]."""

    def step(h, obs):
        return network.apply_step(policy_params, h, obs[..., :22])

    return step, network.initial_hidden(policy_params, batch_size)
