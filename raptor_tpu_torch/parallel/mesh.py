"""Device meshes and the layout of the training state over processes.

Counterpart of `raptor_tpu/parallel/mesh.py`. JAX places one global array on
a `Mesh` with a `NamedSharding` and lets XLA insert the collectives. PyTorch
runs one process a device (`parallel/multihost.py`), so here each process
holds its own block of every sharded axis as a plain tensor, in the block
order a `NamedSharding` uses (process r of n holds rows [r n_rows / n,
(r + 1) n_rows / n)), and the collectives are written out:

  - 'env': environments, replay rows and rollout batches are split along
    their env dimension; the learner is replicated, and its update averages
    the gradients of the processes' minibatch shares (`rl.sac.sac_update`'s
    `group`), which equals one update on the whole minibatch;
  - 'pop': the teacher-population axis; each process trains its block of
    the K learners, which needs no collective except for the metrics;
  - distillation on ('pop', 'env'): each process collects its block of the
    teachers and of their envs (`distill_block`), keeps its block of the
    aggregate (`shard_distill_config`), and the replicated student averages
    its gradients over the group
    (`distill.post_training.make_train_from_aggregate(cfg, group)`).

The mesh is a record of that layout (`Mesh`): JAX's axis names and shape and
this process's place in it, rank r at row-major coordinates. The collectives
run over the whole process group, so the mesh needs no process groups of its
own.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from raptor_tpu_torch.env.types import tree_map
from raptor_tpu_torch.parallel.multihost import (
    host_generator, make_global_array, process_count, process_index)
from raptor_tpu_torch.rl import networks
from raptor_tpu_torch.utils.state_checkpoint import leaves_with_path


def mesh_shape(n: int, axis_names: Sequence[str] = ("env",)) -> tuple:
    """JAX's mesh shape for n devices: (n,), or for two axes the
    factorisation (pop, n // pop) with pop = gcd(n, floor(sqrt(n)))."""
    if len(axis_names) == 1:
        return (n,)
    if len(axis_names) == 2:
        pop = math.gcd(n, max(1, math.isqrt(n)))
        return (pop, n // pop)
    raise ValueError("only 1-D/2-D meshes supported")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The process group laid out as JAX's mesh: the axis names, the shape
    (`mesh_shape`) and this process's coordinates on each axis."""

    axis_names: tuple
    shape: tuple
    coords: tuple

    def _dim(self, name: str) -> int:
        if name not in self.axis_names:
            raise ValueError(f"the mesh has no {name!r} axis: {self.axis_names}")
        return self.axis_names.index(name)

    def size(self, name: str) -> int:
        return self.shape[self._dim(name)]

    def index(self, name: str) -> int:
        return self.coords[self._dim(name)]


def make_mesh(n_devices: Optional[int] = None, axis_names: Sequence[str] = ("env",)) -> Mesh:
    """The mesh over the process group, one process a device, shaped as
    `mesh_shape` (pop outermost, rank r at row-major coordinates). The group
    must hold exactly `n_devices` processes where given."""
    n = process_count()
    if n_devices is not None and n_devices != n:
        raise ValueError(f"a mesh of {n_devices} devices asked for in a group of {n} processes")
    shape = mesh_shape(n, axis_names)
    rank = process_index()
    coords = (rank,) if len(shape) == 1 else divmod(rank, shape[1])
    return Mesh(tuple(axis_names), shape, tuple(coords))


def local_block(x: torch.Tensor, mesh, dim: int, mesh_dim: str = "env") -> torch.Tensor:
    """This process's block of `x` along `dim`, split over the mesh's
    `mesh_dim` axis (a copy); raises ValueError where it does not divide."""
    n, r = mesh.size(mesh_dim), mesh.index(mesh_dim)
    if x.shape[dim] % n:
        raise ValueError(f"axis {dim} of length {x.shape[dim]} does not split over {n} devices")
    size = x.shape[dim] // n
    return x.narrow(dim, r * size, size).clone()


def shard_env_pytree(tree, mesh, env_axis: int = 0, mesh_dim: str = "env"):
    """This process's block of every tensor of `tree` (a tensor or a
    dataclass of them: airframes, env states) along `env_axis`; tensors of
    lower rank and other fields are kept whole. `mesh_dim="pop"` splits a
    population axis the same way."""
    return tree_map(lambda x: local_block(x, mesh, env_axis, mesh_dim)
                    if isinstance(x, torch.Tensor) and x.dim() > env_axis else x, tree)


def shard_buffer_pytree(buffer, mesh):
    """A replay ring [capacity, n_envs, ...] split on its env axis (1);
    the pointer and size stay as they are."""
    return tree_map(lambda x: local_block(x, mesh, 1)
                    if isinstance(x, torch.Tensor) and x.dim() >= 2 else x, buffer)


@torch.no_grad()
def replicate_pytree(tree, mesh=None):
    """Every tensor of `tree`, and every moment of its optimizers, set in
    place to process 0's values (a broadcast over the process group the mesh
    spans). Optimizer step counts, generators and plain numbers stay each
    process's own; returns `tree`."""
    if process_count() == 1:
        return tree
    for _, _, _, leaf in leaves_with_path(tree):
        if isinstance(leaf, torch.Tensor):
            dist.broadcast(leaf, src=0)
        elif isinstance(leaf, torch.optim.Optimizer):
            for st in leaf.state.values():
                for name, v in st.items():
                    if name != "step":
                        dist.broadcast(v, src=0)
    return tree


def shard_runner_config(run_cfg, mesh):
    """This process's share of a `rl.runner.RunnerConfig` on an env-sharded
    mesh: its envs and its share of every minibatch."""
    n = mesh.size("env")
    if run_cfg.n_envs % n or run_cfg.batch_size % n:
        raise ValueError(f"{run_cfg.n_envs} envs and batch {run_cfg.batch_size} do not split "
                         f"over {n} devices")
    return dataclasses.replace(run_cfg, n_envs=run_cfg.n_envs // n,
                               batch_size=run_cfg.batch_size // n)


def shard_distill_config(cfg, mesh):
    """This process's share of a `distill.post_training.DistillConfig` on a
    ('pop', 'env') mesh of N processes: its block of each teacher's envs (M /
    env), of each round's teachers (K_sub / pop), of the aggregate's columns
    (C / N) and of each minibatch (B / N). Raises ValueError where one does
    not divide."""
    n_pop, n_env = mesh.size("pop"), mesh.size("env")
    n = n_pop * n_env
    shares = {"envs_per_teacher": (cfg.envs_per_teacher, n_env),
              "teachers_per_round": (cfg.teachers_per_round, n_pop),
              "aggregate_capacity": (cfg.aggregate_capacity, n),
              "batch_size": (cfg.batch_size, n)}
    bad = [f"{name} {total} over {parts}" for name, (total, parts) in shares.items()
           if total % parts]
    if bad:
        raise ValueError(f"the distillation config does not split: {', '.join(bad)}")
    return dataclasses.replace(cfg, **{name: total // parts
                                       for name, (total, parts) in shares.items()})


def distill_block(teacher_actors, env_params, mesh):
    """This process's block of a distillation population on a ('pop', 'env')
    mesh: teachers [K] split on 'pop', airframes [K, M] on 'pop' and their
    envs on 'env', as (actors [K / pop], env_params [K / pop, M / env]).
    `distill.post_training.make_collect(env, cfg, env_block=(mesh.index("env"),
    mesh.size("env")))` collects it."""
    own = local_block(torch.arange(networks.n_actors(teacher_actors),
                                   device=env_params.mass.device), mesh, 0, "pop")
    actors = networks.take_actors(teacher_actors, own)
    params = shard_env_pytree(shard_env_pytree(env_params, mesh, 0, "pop"), mesh, 1, "env")
    return actors, params


def round_teacher_block(teacher_actors, env_params, idx: torch.Tensor, mesh):
    """One round's teacher subsample on a ('pop', 'env') mesh: `idx` [K_sub]
    are the round's teachers, drawn alike on every process
    (`distill.post_training.draw_round_teachers` from a generator seeded
    alike everywhere, not a `host_generator`), and this process takes its
    'pop' block of them. The teachers' actors and airframes are small (the
    six hover-gate packs hold about 17 MB), so every process holds all K of
    them, replicated, and the subset is indexed locally instead of gathered.
    Returns (actors [K_sub / pop], env_params [K_sub / pop, M / env], the
    process's envs as in `distill_block`); raises ValueError where K_sub
    does not split over 'pop'."""
    n_pop = mesh.size("pop")
    if idx.shape[0] % n_pop:
        raise ValueError(f"{idx.shape[0]} teachers a round do not split over {n_pop} 'pop' "
                         "devices")
    own = local_block(idx, mesh, 0, "pop")
    params = shard_env_pytree(tree_map(lambda x: x[own], env_params), mesh, 1, "env")
    return networks.take_actors(teacher_actors, own), params


def gather_distill_columns(x: torch.Tensor, mesh, k_local: int, axis: int = 1) -> torch.Tensor:
    """The population's columns from every process's block of a
    ('pop', 'env') mesh: `x` holds along `axis` this process's K / pop
    teachers x M / env envs (teacher-major, as `make_collect` returns them);
    the result holds all K x M in one process's order, teacher-major."""
    n_pop, n_env = mesh.size("pop"), mesh.size("env")
    moved = x.movedim(axis, 0)
    m_local = moved.shape[0] // k_local
    full = make_global_array(moved, 0)  # [pop * env * Kl * Ml, ...], rank order
    rest = moved.shape[1:]
    full = full.reshape(n_pop, n_env, k_local, m_local, *rest).transpose(1, 2)
    return full.reshape(n_pop * k_local * n_env * m_local, *rest).movedim(0, axis)


def shard_trainer_state(state, mesh):
    """Lay out a `rl.runner.TrainerState` of one learner over the mesh: the
    learner replicated from process 0, envs, observations and the replay
    ring split on 'env'. Each process gets a generator of its own, seeded
    from a draw of the (replicated) one it had: process 0's stream is the one
    a single process would draw from that seed."""
    seed = int(torch.randint(0, 2**62, (), generator=state.generator,
                             device=state.generator.device))
    return dataclasses.replace(
        state,
        sac=replicate_pytree(state.sac, mesh),
        buffer=shard_buffer_pytree(state.buffer, mesh),
        env_state=shard_env_pytree(state.env_state, mesh),
        obs=local_block(state.obs, mesh, 0),
        generator=host_generator(seed, device=state.generator.device),
    )
