"""Generic off-policy runner: one collect + train scaffold for any learner
(SAC, TD3).

Counterpart of `raptor_tpu/rl/runner_generic.py`. `AlgorithmSpec` is the
small protocol a learner exposes; the runner owns the envs, the replay ring
and the super-step, built on `rl.runner.collect_rollout` and
`rl.runner.train_steps` (one source of the transition and bootstrap
semantics). `rl.runner` stays the SAC path of the teacher farm.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

import torch

from raptor_tpu_torch.env.quad import L2F, EnvState
from raptor_tpu_torch.env.types import DynamicsParams
from raptor_tpu_torch.rl import replay, runner
from raptor_tpu_torch.rl.runner import ACTION_DIM, RunnerConfig


@dataclasses.dataclass(frozen=True)
class AlgorithmSpec:
    """The learner protocol.

    init(generator, obs_dim, action_dim) -> learner_state
    explore(learner_state, generator, obs) -> action     (collection policy)
    update(learner_state, generator, batch) -> (state, metrics)
    """

    init: Callable
    explore: Callable
    update: Callable


def sac_spec(config=None) -> AlgorithmSpec:
    from raptor_tpu_torch.rl import networks, sac

    cfg = config or sac.SACConfig()
    return AlgorithmSpec(
        init=lambda gen, o, a: sac.sac_init(gen, o, a, cfg),
        explore=lambda st, gen, obs: networks.actor_sample(st.actor, obs, gen)[0],
        update=lambda st, gen, batch: sac.sac_update(st, gen, batch, cfg),
    )


def td3_spec(config=None) -> AlgorithmSpec:
    from raptor_tpu_torch.rl import td3

    cfg = config or td3.TD3Config()

    def explore(st, gen, obs):
        a = td3.deterministic_actor_apply(st.actor, obs)
        noise = torch.randn(a.shape, generator=gen, device=a.device) * cfg.exploration_noise_std
        return torch.clamp(a + noise, -1.0, 1.0)

    return AlgorithmSpec(
        init=lambda gen, o, a: td3.td3_init(gen, o, a, cfg),
        explore=explore,
        update=lambda st, gen, batch: td3.td3_update(st, gen, batch, cfg),
    )


@dataclasses.dataclass
class GenericTrainerState:
    learner: Any
    buffer: replay.TransitionBuffer
    env_state: EnvState
    obs: torch.Tensor  # [N, obs_dim]
    generator: torch.Generator
    total_env_steps: int


def generic_trainer_init(
    generator: torch.Generator,
    env: L2F,
    params: DynamicsParams,  # [N] airframes
    run_cfg: RunnerConfig,
    spec: AlgorithmSpec,
) -> GenericTrainerState:
    """A fresh learner, reset envs and an empty ring on the generator's
    device."""
    obs_dim = env.OBSERVATION_DIM
    learner = spec.init(generator, run_cfg.actor_obs_dim or obs_dim, ACTION_DIM)
    env_state, obs = env.reset(params, generator)
    buffer = replay.transition_buffer_init(
        run_cfg.replay_capacity, run_cfg.n_envs, obs_dim, ACTION_DIM, generator.device)
    return GenericTrainerState(learner=learner, buffer=buffer, env_state=env_state, obs=obs,
                               generator=generator, total_env_steps=0)


def make_generic_super_step(env: L2F, run_cfg: RunnerConfig, spec: AlgorithmSpec,
                            random_actions: bool = False):
    """(state, params) -> (state, metrics): collect H, write the ring, train
    G. Updates the state in place."""

    def super_step(state: GenericTrainerState, params) -> Tuple[GenericTrainerState, Any]:
        gen = state.generator
        es, obs, transitions = runner.collect_rollout(
            env, params, run_cfg, lambda o: spec.explore(state.learner, gen, o),
            state.env_state, state.obs, gen, random_actions)
        replay.transition_buffer_add_rollout(state.buffer, *transitions)
        state.learner, last = runner.train_steps(
            run_cfg, lambda st, batch: spec.update(st, gen, batch), state.buffer,
            state.learner, gen)
        state.env_state, state.obs = es, obs
        state.total_env_steps += run_cfg.rollout_length * run_cfg.n_envs
        return state, last

    return super_step
