"""Population teacher training: K SAC teachers, one per sampled airframe,
trained in lockstep as one program.

Counterpart of `raptor_tpu/distill/population.py`. The JAX package `vmap`s the
whole trainer over a population axis K; here the population is a leading [K]
axis on the learners, the replay ring and the observations, while the envs
run on the flattened [K*N] axis (`rl/runner.py`). The "states" these functions
pass around are one `runner.TrainerState` with stacked tensors, updated in
place.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from raptor_tpu_torch.env.quad import L2F
from raptor_tpu_torch.env.randomization import RandomizationConfig, sample_population
from raptor_tpu_torch.env.types import DynamicsParams, State, tree_map
from raptor_tpu_torch.rl import evaluation, networks, runner, sac


@dataclasses.dataclass(frozen=True)
class PopulationConfig:
    n_teachers: int = 8  # K
    envs_per_teacher: int = 32
    rollout_length: int = 16
    gradient_steps: int = 16
    batch_size: int = 256
    replay_capacity: int = 4096
    warmup_super_steps: int = 8
    sample_rows: bool = False  # row-contiguous replay sampling (see rl/replay.py)


def sample_teacher_airframes(
    generator: torch.Generator,
    n_teachers: int,
    config: RandomizationConfig = RandomizationConfig(),
) -> DynamicsParams:
    """K randomized airframes, one per teacher, on the generator's device."""
    return sample_population(generator, n_teachers, config)


def broadcast_airframe_to_envs(params: DynamicsParams, n_envs: int) -> DynamicsParams:
    """[K, ...] airframes -> [K, n_envs, ...] views (each teacher's airframe
    repeated over its envs)."""
    return tree_map(lambda x: x[:, None].expand(x.shape[0], n_envs, *x.shape[1:]), params)


def flatten_envs(env_params: DynamicsParams) -> DynamicsParams:
    """[K, M, ...] -> [K*M, ...], teacher-major."""
    return tree_map(lambda x: x.reshape(x.shape[0] * x.shape[1], *x.shape[2:]), env_params)


def population_init(
    generator: torch.Generator,
    env: L2F,
    airframes: DynamicsParams,  # [K]
    pop_cfg: PopulationConfig,
    sac_cfg: sac.SACConfig = sac.SACConfig(),
):
    """`runner.trainer_init` for K stacked teachers on the generator's device:
    (states, env_params [K, N], run_cfg)."""
    run_cfg = runner.RunnerConfig(
        n_envs=pop_cfg.envs_per_teacher,
        rollout_length=pop_cfg.rollout_length,
        gradient_steps=pop_cfg.gradient_steps,
        batch_size=pop_cfg.batch_size,
        replay_capacity=pop_cfg.replay_capacity,
        sample_rows=pop_cfg.sample_rows,
    )
    env_params = broadcast_airframe_to_envs(airframes, pop_cfg.envs_per_teacher)
    states = runner.trainer_init(generator, env, env_params, run_cfg, sac_cfg)
    return states, env_params, run_cfg


def make_population_super_step(env: L2F, run_cfg: runner.RunnerConfig, sac_cfg: sac.SACConfig):
    """(states, env_params) -> (states, metrics [K]): one collect + train
    super-step of all K teachers."""
    return runner.make_super_step(env, run_cfg, sac_cfg)


def make_population_multi_step(
    env: L2F,
    run_cfg: runner.RunnerConfig,
    sac_cfg: sac.SACConfig,
    n_inner: int,
    unroll: bool = True,
):
    """`n_inner` population super-steps in one call; returns the metrics of
    the last inner step.

    `unroll` is accepted for the JAX package's signature and changes nothing:
    eager PyTorch runs the inner steps as a Python loop either way, and the
    replay ring is updated in place, so there is no loop carry to copy."""
    super_step = runner.make_super_step(env, run_cfg, sac_cfg)

    def multi(states, env_params):
        for _ in range(n_inner):
            states, metrics = super_step(states, env_params)
        return states, metrics

    return multi


def make_population_demo_collect(env: L2F, run_cfg: runner.RunnerConfig, adaptive: bool = False):
    """(states, env_params) -> states: one scripted-demonstrator collect for
    every teacher (replay seeding with demonstrations)."""

    def demo_collect(states, env_params):
        return runner.collect_scripted(states, env, env_params, run_cfg, adaptive)

    return demo_collect


def make_population_warmup(env: L2F, run_cfg: runner.RunnerConfig):
    return runner.make_warmup_step(env, run_cfg)


def make_population_eval(env: L2F, n_eval_envs: int, episode_length: int):
    """Per-teacher deterministic evaluation on its own airframe:
    (sac_state with [K]-stacked actors, airframes [K], generator) -> the
    5-stat tuple with one value per member, each [K]. `state` ([K *
    n_eval_envs] initial states, teacher-major) replaces the draws from the
    generator where given."""

    @torch.no_grad()
    def evaluate(sac_state, airframes: DynamicsParams, generator: torch.Generator,
                 state: Optional[State] = None):
        k = airframes.mass.shape[0]
        params = flatten_envs(broadcast_airframe_to_envs(airframes, n_eval_envs))
        if state is None:
            state = env.reset(params, generator)[0].dynamics

        def step(carry, obs):
            obs_k = obs.reshape(k, n_eval_envs, -1)
            return carry, networks.actor_mean(sac_state.actor, obs_k).reshape(k * n_eval_envs, -1)

        ret, length, alive = evaluation.run_episodes(
            env, params, state, step, (), generator, episode_length)
        return evaluation.summarize(
            ret.reshape(k, -1), length.reshape(k, -1), alive.reshape(k, -1))

    return evaluate


def train_population(
    generator: torch.Generator,
    env: L2F,
    pop_cfg: PopulationConfig,
    sac_cfg: sac.SACConfig,
    n_super_steps: int,
    rand_cfg: RandomizationConfig = RandomizationConfig(),
    log_fn=None,
    eval_every: int = 0,
) -> Tuple:
    """End-to-end population pre-training on the generator's device. Returns
    (sac_state with [K]-stacked learners, airframes [K])."""
    airframes = sample_teacher_airframes(generator, pop_cfg.n_teachers, rand_cfg)
    states, env_params, run_cfg = population_init(generator, env, airframes, pop_cfg, sac_cfg)
    warmup = make_population_warmup(env, run_cfg)
    super_step = make_population_super_step(env, run_cfg, sac_cfg)
    evaluator = make_population_eval(env, 8, env.EPISODE_LENGTH) if eval_every else None
    eval_seed = int(torch.randint(0, 2**31 - 1, (), generator=generator, device=generator.device))

    for _ in range(pop_cfg.warmup_super_steps):
        states = warmup(states, env_params)
    for i in range(n_super_steps):
        states, metrics = super_step(states, env_params)
        if log_fn is not None:
            log_fn(i, metrics)
        if eval_every and (i + 1) % eval_every == 0 and log_fn is not None:
            # the same evaluation episodes every time
            eval_gen = torch.Generator(device=generator.device).manual_seed(eval_seed)
            log_fn(i, evaluator(states.sac, airframes, eval_gen))
    return states.sac, airframes
