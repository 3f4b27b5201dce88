"""Recurrent off-policy runner: sequence collection and BPTT SAC super-steps.

Counterpart of `raptor_tpu/rl/runner_gru.py`, the recurrent sibling of
`rl.runner`: the rollout carries the actor's GRU hidden state (re-injected
with h0 exactly where envs auto-reset), writes time rows into the
`SequenceBuffer`, and the train phase samples [B, T] windows for
`sac_gru_update`. Runs eagerly; every function updates the state it is given
in place and returns it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from raptor_tpu_torch.env.quad import L2F, EnvState
from raptor_tpu_torch.env.types import DynamicsParams
from raptor_tpu_torch.policy import network as gru_net
from raptor_tpu_torch.rl import networks, replay, sac_gru
from raptor_tpu_torch.rl.runner import ACTION_DIM


@dataclasses.dataclass(frozen=True)
class GRURunnerConfig:
    n_envs: int = 64
    rollout_length: int = 64
    gradient_steps: int = 8
    batch_size: int = 32  # sequences per update
    sample_seq_len: int = 32  # BPTT window
    replay_capacity: int = 4096  # time rows
    actor_obs_dim: int = 22  # the policy observation slice


@dataclasses.dataclass
class GRUTrainerState:
    learner: sac_gru.SACGRUState
    buffer: replay.SequenceBuffer
    env_state: EnvState
    obs: torch.Tensor  # [N, obs_dim]
    hidden: torch.Tensor  # [N, H] actor hidden carried across super-steps
    just_reset: torch.Tensor  # [N] 1.0 where the env was reset before the next step
    generator: torch.Generator
    total_env_steps: int


def gru_trainer_init(
    generator: torch.Generator,
    env: L2F,
    params: DynamicsParams,  # [N] airframes
    run_cfg: GRURunnerConfig,
    cfg: sac_gru.SACGRUConfig = sac_gru.SACGRUConfig(),
) -> GRUTrainerState:
    """A fresh learner, reset envs and an empty ring on the generator's
    device."""
    if cfg.actor_obs_dim is not None:
        # privileged critics: the learner sees the full env obs and slices
        # the actor's part itself; the two configs must agree
        if cfg.actor_obs_dim != run_cfg.actor_obs_dim:
            raise ValueError(f"actor_obs_dim {cfg.actor_obs_dim} != runner's "
                             f"{run_cfg.actor_obs_dim}")
        learner_obs_dim = env.OBSERVATION_DIM
    else:
        learner_obs_dim = run_cfg.actor_obs_dim
    learner = sac_gru.sac_gru_init(generator, learner_obs_dim, ACTION_DIM, cfg)
    env_state, obs = env.reset(params, generator)
    buffer = replay.sequence_buffer_init(
        run_cfg.replay_capacity, run_cfg.n_envs, env.OBSERVATION_DIM, ACTION_DIM,
        generator.device)
    return GRUTrainerState(
        learner=learner, buffer=buffer, env_state=env_state, obs=obs,
        hidden=gru_net.initial_hidden(learner.actor, run_cfg.n_envs).detach(),
        just_reset=torch.ones(run_cfg.n_envs, device=generator.device),
        generator=generator, total_env_steps=0,
    )


@torch.no_grad()
def collect_sequences(
    state: GRUTrainerState,
    env: L2F,
    params: DynamicsParams,
    run_cfg: GRURunnerConfig,
    cfg: sac_gru.SACGRUConfig,
    random_actions: bool = False,
    noise: Optional[torch.Tensor] = None,
) -> GRUTrainerState:
    """H steps of all envs with the current actor (or U(-1, 1) actions),
    written into the ring as rows (obs, action, reward, terminated,
    just_reset). The hidden state is reset to h0 where `just_reset` before
    the step; `just_reset` of the next step is `done`, truncation included.
    `noise` [H, N, act] replaces the generator's draws for the actor's
    actions."""
    actor, gen = state.learner.actor, state.generator
    h0 = gru_net.initial_hidden(actor, run_cfg.n_envs)
    es, obs, h, just_reset = state.env_state, state.obs, state.hidden, state.just_reset
    rows = []
    for t in range(run_cfg.rollout_length):
        h = torch.where(just_reset[:, None] != 0, h0, h)
        h_new, out = gru_net.apply_step(actor, h, obs[..., : run_cfg.actor_obs_dim])
        mu, log_std = out.chunk(2, -1)
        log_std = torch.clamp(log_std, cfg.log_std_min, cfg.log_std_max)
        if random_actions:
            action = torch.rand(mu.shape, generator=gen, device=mu.device) * 2.0 - 1.0
        else:
            action, _ = networks.sample_and_squash(
                mu, log_std, gen, None if noise is None else noise[t])
        es, next_obs, reward, done, info = env.step(params, es, action, gen)
        rows.append((obs, action, reward, info["terminated"].float(), just_reset))
        obs, h, just_reset = next_obs, h_new, done.float()
    replay.sequence_buffer_add_rollout(
        state.buffer, *(torch.stack([row[i] for row in rows]) for i in range(5)))
    state.env_state, state.obs, state.hidden, state.just_reset = es, obs, h, just_reset
    state.total_env_steps += run_cfg.rollout_length * run_cfg.n_envs
    return state


def train_sequences(
    state: GRUTrainerState, run_cfg: GRURunnerConfig, cfg: sac_gru.SACGRUConfig,
) -> Tuple[GRUTrainerState, sac_gru.SACGRUMetrics]:
    """G BPTT updates on windows sampled from the ring; returns the last
    step's metrics."""
    metrics = None
    for _ in range(run_cfg.gradient_steps):
        batch = replay.sequence_buffer_sample(
            state.buffer, state.generator, run_cfg.batch_size, run_cfg.sample_seq_len)
        if cfg.actor_obs_dim is None:
            # symmetric mode: everything trains on the policy slice
            batch["obs"] = batch["obs"][..., : run_cfg.actor_obs_dim]
        state.learner, metrics = sac_gru.sac_gru_update(
            state.learner, state.generator, batch, cfg)
    return state, metrics


def make_gru_super_step(env: L2F, run_cfg: GRURunnerConfig, cfg: sac_gru.SACGRUConfig):
    """(state, params) -> (state, metrics): collect H, then train G."""

    def super_step(state: GRUTrainerState, params: DynamicsParams):
        state = collect_sequences(state, env, params, run_cfg, cfg)
        return train_sequences(state, run_cfg, cfg)

    return super_step


def make_gru_multi_step(env: L2F, run_cfg: GRURunnerConfig, cfg: sac_gru.SACGRUConfig,
                        n_inner: int):
    """n_inner super-steps a call; returns the last one's metrics."""
    super_step = make_gru_super_step(env, run_cfg, cfg)

    def multi(state: GRUTrainerState, params: DynamicsParams):
        for _ in range(n_inner - 1):
            state, _ = super_step(state, params)
        return super_step(state, params)

    return multi
