"""Teacher populations: K airframes, one per teacher, and their broadcast to
the M envs each teacher's airframe is flown in.

Counterpart of `sample_teacher_airframes` and `broadcast_airframe_to_envs` in
`raptor_tpu/distill/population.py`.
"""

from __future__ import annotations

import torch

from raptor_tpu_torch.env.randomization import RandomizationConfig, sample_population
from raptor_tpu_torch.env.types import DynamicsParams, tree_map


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
