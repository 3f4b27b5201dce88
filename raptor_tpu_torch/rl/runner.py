"""Off-policy runner: collect + train super-steps.

Counterpart of `raptor_tpu/rl/runner.py`. One super-step rolls H env steps of
N envs, writes the rollout into the replay ring, then runs G SAC gradient
steps. Where the JAX package jits one program and `vmap`s it over a teacher
population, this runs eagerly and the population is a leading [K] axis: the
environment runs on the flattened [K*N] env axis (one batch of envs, as
`distill.population.flatten_envs` lays it out), the networks, the ring and the
observations carry [K, N, d]. Without the [K] axis (airframes [N]) the same
functions run one learner.

`TrainerState` is a mutable dataclass; every function here updates the state
it is given in place and returns it. Randomness comes from the state's one
`torch.Generator`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from raptor_tpu_torch.env.quad import L2F, EnvState
from raptor_tpu_torch.env.recovery import recovery_action
from raptor_tpu_torch.env.types import DynamicsParams, tree_map
from raptor_tpu_torch.rl import networks, replay, sac

ACTION_DIM = 4


@dataclasses.dataclass(frozen=True)
class RunnerConfig:
    n_envs: int = 64  # N, per learner
    rollout_length: int = 32  # H env steps per super-step
    gradient_steps: int = 32  # G SAC updates per super-step
    batch_size: int = 256
    replay_capacity: int = 4096  # time rows (x n_envs transitions)
    actor_obs_dim: Optional[int] = None  # policy sees obs[:, :this]; None = full
    # row-contiguous replay sampling (batch = random whole time rows), see
    # replay.transition_buffer_sample_rows
    sample_rows: bool = False


@dataclasses.dataclass
class TrainerState:
    sac: sac.SACState
    buffer: replay.TransitionBuffer
    env_state: EnvState  # flattened [K*N] (or [N])
    obs: torch.Tensor  # [K, N, obs_dim] (or [N, obs_dim])
    generator: torch.Generator
    total_env_steps: int  # per learner


def _flat(params: DynamicsParams) -> DynamicsParams:
    """[K, N, ...] or [N, ...] airframes -> the flattened env axis."""
    lead = params.mass.dim()
    return tree_map(lambda x: x.reshape(-1, *x.shape[lead:]), params)


def trainer_init(
    generator: torch.Generator,
    env: L2F,
    params: DynamicsParams,  # [N] airframes, or [K, N] for K learners
    run_cfg: RunnerConfig,
    sac_cfg: sac.SACConfig = sac.SACConfig(),
) -> TrainerState:
    """Fresh learner(s), reset envs and an empty ring on the generator's
    device."""
    lead = tuple(params.mass.shape)
    if lead[-1] != run_cfg.n_envs:
        raise ValueError(f"params hold {lead[-1]} envs a learner, n_envs={run_cfg.n_envs}")
    n_stack = lead[0] if len(lead) == 2 else None
    obs_dim = env.OBSERVATION_DIM
    sac_state = sac.sac_init(
        generator, run_cfg.actor_obs_dim or obs_dim, ACTION_DIM, sac_cfg, n_stack)
    env_state, obs = env.reset(_flat(params), generator)
    buffer = replay.transition_buffer_init(
        run_cfg.replay_capacity, run_cfg.n_envs, obs_dim, ACTION_DIM, generator.device, n_stack)
    return TrainerState(
        sac=sac_state, buffer=buffer, env_state=env_state, obs=obs.reshape(*lead, obs_dim),
        generator=generator, total_env_steps=0,
    )


def _actor_slice(obs: torch.Tensor, run_cfg: RunnerConfig) -> torch.Tensor:
    if run_cfg.actor_obs_dim is None:
        return obs
    return obs[..., : run_cfg.actor_obs_dim]


def _step_row(env, flat_params, es, obs, action, generator):
    """One env step of all envs: (es, next obs, the transition row). The row
    uses info['final_obs'] (the observation before an auto-reset) as the
    bootstrap target and counts only true terminations, not truncations, as
    `done`."""
    lead = obs.shape[:-1]
    es, next_obs, reward, _, info = env.step(
        flat_params, es, action.reshape(-1, ACTION_DIM), generator)
    row = (
        obs, action, reward.reshape(lead), info["final_obs"].reshape(obs.shape),
        info["terminated"].float().reshape(lead),
    )
    return es, next_obs.reshape(obs.shape), row


def _stack_rows(rows, lead_dims: int):
    """H transition rows -> five arrays [..., H, N, d]."""
    return tuple(torch.stack([row[i] for row in rows], lead_dims - 1) for i in range(5))


@torch.no_grad()
def collect_rollout(
    env: L2F,
    params: DynamicsParams,  # [K, N] or [N]
    run_cfg: RunnerConfig,
    explore: Optional[Callable],
    es: EnvState,
    obs: torch.Tensor,
    generator: torch.Generator,
    random_actions: bool = False,
):
    """H steps of all envs, transitions out (see `_step_row` for their
    semantics).

    explore: obs_sliced [..., N, d] -> action [..., N, 4].
    Returns (es, obs, (o, a, r, next_o, d)) with the transitions stacked
    [..., H, N, d]."""
    lead = tuple(params.mass.shape)
    flat_params = _flat(params)
    rows = []
    for _ in range(run_cfg.rollout_length):
        if random_actions:
            action = torch.rand((*lead, ACTION_DIM), generator=generator,
                                device=obs.device) * 2.0 - 1.0
        else:
            action = explore(_actor_slice(obs, run_cfg))
        es, obs, row = _step_row(env, flat_params, es, obs, action, generator)
        rows.append(row)
    return es, obs, _stack_rows(rows, len(lead))


def train_steps(run_cfg: RunnerConfig, update: Callable, buffer: replay.TransitionBuffer,
                learner, generator: torch.Generator):
    """G gradient steps: sample minibatches from replay, apply
    `update: (learner, batch) -> (learner, metrics)`. Returns (learner, the
    last step's metrics)."""
    sample = (
        replay.transition_buffer_sample_rows
        if run_cfg.sample_rows
        else replay.transition_buffer_sample
    )
    metrics = None
    for _ in range(run_cfg.gradient_steps):
        obs, action, reward, next_obs, done = sample(buffer, generator, run_cfg.batch_size)
        batch = (
            _actor_slice(obs, run_cfg), action, reward, _actor_slice(next_obs, run_cfg), done,
        )
        learner, metrics = update(learner, batch)
    return learner, metrics


def _store(state: TrainerState, run_cfg: RunnerConfig, es, obs, transitions) -> TrainerState:
    replay.transition_buffer_add_rollout(state.buffer, *transitions)
    state.env_state, state.obs = es, obs
    state.total_env_steps += run_cfg.rollout_length * run_cfg.n_envs
    return state


def collect(
    state: TrainerState,
    env: L2F,
    params: DynamicsParams,
    run_cfg: RunnerConfig,
    random_actions: bool = False,
) -> TrainerState:
    """Roll H steps with the current SAC actor (or uniform [-1, 1] actions)
    and write the transitions into the ring."""

    def explore(o):
        return networks.actor_sample(state.sac.actor, o, state.generator)[0]

    es, obs, transitions = collect_rollout(
        env, params, run_cfg, explore, state.env_state, state.obs, state.generator,
        random_actions,
    )
    return _store(state, run_cfg, es, obs, transitions)


def collect_scripted(
    state: TrainerState,
    env: L2F,
    params: DynamicsParams,
    run_cfg: RunnerConfig,
    adaptive: bool = False,
) -> TrainerState:
    """Demonstration collection: roll H steps under the scripted recovery
    demonstrator (`env.recovery`) instead of the SAC actor and write the
    transitions into the ring, so the critics see the value of the fast flip
    that SAC's exploration does not find. Pair with an init-severity
    curriculum (`InitConfig.angle_power`) so the demonstrations start from
    the severe attitudes."""
    lead = tuple(params.mass.shape)
    flat_params = _flat(params)
    es, obs, rows = state.env_state, state.obs, []
    with torch.no_grad():
        for _ in range(run_cfg.rollout_length):
            action = recovery_action(flat_params, es.dynamics, adaptive=adaptive)
            es, obs, row = _step_row(
                env, flat_params, es, obs, action.reshape(*lead, ACTION_DIM), state.generator)
            rows.append(row)
    return _store(state, run_cfg, es, obs, _stack_rows(rows, len(lead)))


def train(
    state: TrainerState, run_cfg: RunnerConfig, sac_cfg: sac.SACConfig
) -> Tuple[TrainerState, sac.SACMetrics]:
    """G SAC gradient steps on minibatches from replay."""

    def update(learner, batch):
        return sac.sac_update(learner, state.generator, batch, sac_cfg)

    state.sac, last = train_steps(run_cfg, update, state.buffer, state.sac, state.generator)
    return state, last


def make_super_step(env: L2F, run_cfg: RunnerConfig, sac_cfg: sac.SACConfig):
    """(state, params) -> (state, metrics): collect H, then train G."""

    def super_step(state: TrainerState, params: DynamicsParams):
        state = collect(state, env, params, run_cfg)
        return train(state, run_cfg, sac_cfg)

    return super_step


def make_warmup_step(env: L2F, run_cfg: RunnerConfig):
    def warmup(state: TrainerState, params: DynamicsParams):
        return collect(state, env, params, run_cfg, random_actions=True)

    return warmup
