"""The multi-device dry run: the training paths of the port, each once, over
N devices at tiny shapes, with the layouts of `parallel/mesh.py`.

    python -m raptor_tpu_torch.parallel.dryrun --devices 2 --platform cpu
    python -m raptor_tpu_torch.parallel.dryrun --devices 1,2,4   # the cards

Counterpart of `__graft_entry__.py` `dryrun_multichip(n)`. JAX places global
arrays on a mesh and lets XLA insert the collectives; the port runs one
process a device (NCCL between cards, gloo between CPU processes), each on
its block, with the collectives written out. Four sections, at JAX's shapes:

1. one SAC super-step of one learner: 4 x N envs split on 'env', the
   learner replicated (rollout 2, 2 gradient steps of 32, replay 64, hidden
   (32, 32));
2. the teacher population on a ('pop', 'env') mesh: 2 x pop teachers x 4
   envs, split on 'pop' (rollout 2, 2 gradient steps of 16, replay 32, row
   sampling), one super-step, then one adaptive demonstrator collect. The
   processes of one 'pop' block draw from one stream, so they compute the
   same teachers, as JAX's replicas do;
3. distillation on the same mesh: 2 x pop teachers x 4 envs, each process
   collecting its block of the teachers and of their envs, rollout 8, the
   demonstrator flags of JAX's dry run, one round at beta 0.5; one
   subsampled round at beta 0 from K / 2 teachers drawn alike on every
   process; the aggregate (capacity 8 x N) split in column blocks, and 2 of
   4 gradient steps of batch 8 on the replicated student;
4. collect kernel B3 on 1,024 rows a process, 8 steps, seed 3, with
   `env_offset` = rank x 1,024, gathered and held bit for bit against one
   launch on all rows.

Each process asserts that every loss and observation is finite and that the
shapes are right; the learners' and the students' parameters are gathered
and must be equal on every rank bit for bit. Every process reports its
kernel launches (on a card the collect kernel and the distillation's BPTT
kernels; the plain versions on the CPU launch none). Rank 0 prints one JSON report.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from raptor_tpu_torch.parallel.multihost import make_global_array, run_processes

ROWS_PER_PROCESS = 1024  # one lane tile a device, as in JAX's dry run


def _equal_on_every_rank(tensors, what: str) -> None:
    """Raises unless the concatenation of `tensors` is equal on every rank,
    bit for bit."""
    flat = torch.cat([t.detach().reshape(-1) for t in tensors])
    every = make_global_array(flat[None], 0)
    if not bool((every == every[0]).all()):
        raise AssertionError(f"{what}: the ranks differ")


def _finite(x: torch.Tensor, what: str) -> None:
    if not bool(torch.isfinite(x).all()):
        raise AssertionError(f"{what}: non-finite values")


def run_sections(device: torch.device) -> dict:
    """The four sections in this process of the group; returns its report."""
    import torch.distributed as dist

    from raptor_tpu_torch.distill import population
    from raptor_tpu_torch.distill import post_training
    from raptor_tpu_torch.env import EnvConfig, L2F, sample_population
    from raptor_tpu_torch.env.types import tree_map
    from raptor_tpu_torch.ops.collect import make_fused_collect
    from raptor_tpu_torch.parallel import (
        distill_block, gather_distill_columns, make_mesh, replicate_pytree, round_teacher_block,
        shard_distill_config, shard_env_pytree, shard_runner_config, shard_trainer_state)
    from raptor_tpu_torch.parallel.multihost import host_generator, process_count, process_index
    from raptor_tpu_torch.policy import network as student_net
    from raptor_tpu_torch.rl import networks, runner, sac
    from raptor_tpu_torch.utils.profiling import launches, reset_launches

    n, rank = process_count(), process_index()
    group = dist.group.WORLD if dist.is_initialized() else None
    reset_launches()
    seeded = lambda seed: torch.Generator(device=device).manual_seed(seed)  # noqa: E731
    env = L2F(EnvConfig())
    report = {"rank": rank, "devices": n, "seconds": {}}

    # 1. one SAC super-step: envs split on 'env', the learner replicated
    t0 = time.perf_counter()
    run_cfg = runner.RunnerConfig(n_envs=4 * n, rollout_length=2, gradient_steps=2,
                                  batch_size=32, replay_capacity=64)
    sac_cfg = sac.SACConfig(actor_hidden=(32, 32), critic_hidden=(32, 32))
    params = sample_population(seeded(0), run_cfg.n_envs)
    state = runner.trainer_init(seeded(1), env, params, run_cfg, sac_cfg)
    mesh = make_mesh(n)
    state = shard_trainer_state(state, mesh)
    local_cfg = shard_runner_config(run_cfg, mesh)
    state, metrics = runner.make_super_step(env, local_cfg, sac_cfg, group)(
        state, shard_env_pytree(params, mesh))
    _finite(metrics.critic_loss, "SAC super-step critic loss")
    if state.obs.shape != (4, env.OBSERVATION_DIM):
        raise AssertionError(f"SAC super-step: a process's obs {tuple(state.obs.shape)}")
    _equal_on_every_rank(
        [*networks.tree_leaves(state.sac.actor), *networks.tree_leaves(state.sac.critic),
         state.sac.log_alpha], "SAC learner")
    report["sac_critic_loss"] = float(metrics.critic_loss)
    report["seconds"]["sac"] = time.perf_counter() - t0

    # 2. the teacher population split on 'pop', its super-step and a
    # demonstrator collect
    t0 = time.perf_counter()
    mesh2 = make_mesh(n, ("pop", "env"))
    k_pop = mesh2.size("pop")
    pop_cfg = population.PopulationConfig(
        n_teachers=2, envs_per_teacher=4, rollout_length=2, gradient_steps=2, batch_size=16,
        replay_capacity=32, sample_rows=True)
    airframes = shard_env_pytree(population.sample_teacher_airframes(seeded(2), 2 * k_pop),
                                 mesh2, mesh_dim="pop")
    states, env_params, prun_cfg = population.population_init(
        host_generator(3, mesh2.index("pop"), device), env, airframes, pop_cfg, sac_cfg)
    states, pop_metrics = population.make_population_super_step(env, prun_cfg, sac_cfg)(
        states, env_params)
    _finite(pop_metrics.critic_loss, "population critic loss")
    states = population.make_population_demo_collect(env, prun_cfg, adaptive=True)(
        states, env_params)
    _finite(states.obs, "population obs after the demonstrator collect")
    if states.obs.shape != (2, 4, env.OBSERVATION_DIM):
        raise AssertionError(f"population: a process's obs {tuple(states.obs.shape)}")
    report["population_critic_loss"] = pop_metrics.critic_loss.tolist()
    report["seconds"]["population"] = time.perf_counter() - t0

    # 3. distillation on ('pop', 'env')
    t0 = time.perf_counter()
    k, m = 2 * k_pop, 4
    dcfg = post_training.DistillConfig(
        envs_per_teacher=m, rollout_length=8, batch_size=8, teacher_mix_decay_rounds=1,
        aggregate_capacity=8 * n, grad_steps_per_round=2, total_grad_steps=4,
        demo_tilt=1.2, demo_rate=5.0, demo_rollout_frac=0.25, demo_adaptive=True,
        demo_w_cap=999.0, demo_k_w=999.0, demo_c_flip=0.65, demo_c_bw=2.0, severe_weight=4.0)
    part = shard_distill_config(dcfg, mesh2)
    d_airframes = population.sample_teacher_airframes(seeded(4), k)
    teachers = networks.actor_init(seeded(5), env.OBSERVATION_DIM, 4, (16, 16), n_stack=k)
    d_env_params = population.broadcast_airframe_to_envs(d_airframes, m)
    student = replicate_pytree(student_net.init_params(seeded(6)), mesh2)
    for leaf in networks.tree_leaves(student):
        leaf.requires_grad_(True)
    collect = post_training.make_collect(
        env, part, env_block=(mesh2.index("env"), mesh2.size("env")))
    actors_b, params_b = distill_block(teachers, d_env_params, mesh2)
    data = collect(student, actors_b, params_b, host_generator(7, device=device), 0.5)
    k_local = k // k_pop
    cols = k_local * part.envs_per_teacher
    if data.obs.shape != (8, cols, 22):
        raise AssertionError(f"distill collect: a process's obs {tuple(data.obs.shape)}")
    whole = gather_distill_columns(data.obs, mesh2, k_local)
    if whole.shape != (8, k * m, 22):
        raise AssertionError(f"distill collect: gathered obs {tuple(whole.shape)}")
    _finite(whole, "distill collect obs")

    # one subsampled round: K / 2 teachers, drawn alike on every process
    idx = post_training.draw_round_teachers(seeded(11), k, k // 2)
    sub_actors, sub_params = round_teacher_block(teachers, d_env_params, idx, mesh2)
    _equal_on_every_rank([idx.float()], "subsampled teachers")
    sub = collect(student, sub_actors, sub_params, host_generator(12, device=device), 0.0)
    sub_whole = gather_distill_columns(sub.obs, mesh2, (k // 2) // k_pop)
    if sub_whole.shape != (8, (k // 2) * m, 22):
        raise AssertionError(f"subsampled collect: gathered obs {tuple(sub_whole.shape)}")
    _finite(sub_whole, "subsampled collect obs")

    agg = post_training.aggregate_init(part, device)
    agg = post_training.make_aggregate_add(part)(agg, data, host_generator(8, device=device))
    if agg.obs.shape != (8, dcfg.aggregate_capacity // n, 22) or agg.size != cols:
        raise AssertionError(f"aggregate block {tuple(agg.obs.shape)}, {agg.size} columns")
    train_round, optim_init = post_training.make_train_from_aggregate(part, group)
    student, _, losses = train_round(student, optim_init(student), agg,
                                     host_generator(9, device=device))
    _finite(losses, "distillation losses")
    _equal_on_every_rank(networks.tree_leaves(student), "student")
    report["distill_losses"] = losses.tolist()
    report["seconds"]["distill"] = time.perf_counter() - t0

    # 4. B3 on 1,024 rows a process, env ids offset by the rank
    t0 = time.perf_counter()
    n_rows = ROWS_PER_PROCESS * n
    f_params = tree_map(lambda x: x.repeat_interleave(n_rows // k, 0)[:n_rows], d_airframes)
    f_state = env.sample_state(f_params, seeded(10))
    fused = make_fused_collect(student, 8, env.config, device=device)
    rows = mesh.index("env") * ROWS_PER_PROCESS
    block = tree_map(lambda x: x.narrow(0, rows, ROWS_PER_PROCESS), f_params)
    obs, reset = fused(block, tree_map(lambda x: x.narrow(0, rows, ROWS_PER_PROCESS), f_state),
                       3, rows)
    obs_all, reset_all = make_global_array(obs, 1), make_global_array(reset, 1)
    if obs_all.shape != (8, n_rows, 22):
        raise AssertionError(f"B3 sharded: gathered obs {tuple(obs_all.shape)}")
    _finite(obs_all, "B3 sharded obs")
    one_obs, one_reset = fused(f_params, f_state, 3, 0)
    report["b3_equals_one_launch"] = bool(torch.equal(obs_all, one_obs)
                                          and torch.equal(reset_all, one_reset))
    if not report["b3_equals_one_launch"]:
        raise AssertionError("B3 sharded: the gathered blocks differ from one launch on all rows")
    report["seconds"]["b3"] = time.perf_counter() - t0
    report["launches"] = dict(launches)
    return report


def _worker(n: int, rank: int, port: int, platform: str) -> dict:
    """One process of the dry run; rank 0 returns the report of all ranks."""
    import torch.distributed as dist

    from raptor_tpu_torch.apps.roofline import card_name_and_power_limit
    from raptor_tpu_torch.parallel.multihost import initialize_distributed

    if platform == "cuda":
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    initialize_distributed(f"localhost:{port}", n, rank, device)
    t0 = time.perf_counter()
    mine = run_sections(device)
    mine["seconds"]["total"] = time.perf_counter() - t0
    every = [None] * n
    dist.all_gather_object(every, mine)
    dist.destroy_process_group()
    return {
        "devices": n, "platform": device.type, "backend": "nccl" if platform == "cuda" else "gloo",
        "card": card_name_and_power_limit() if device.type == "cuda" else None,
        "ranks": every,
        "launches": {name: sum(r["launches"][name] for r in every) for name in every[0]["launches"]},
    }


def dryrun_multichip(n_devices: int, platform: str = "cuda", timeout: float = 900) -> dict:
    """The dry run over `n_devices` processes, one a device: `cuda` puts
    process r on card r (NCCL), `cpu` runs gloo processes on the host.
    Returns the report; raises where a process fails."""
    if platform == "cuda" and n_devices > torch.cuda.device_count():
        raise ValueError(f"{n_devices} devices asked for, this host has "
                         f"{torch.cuda.device_count()} CUDA device(s)")
    outs = run_processes(n_devices, "raptor_tpu_torch.parallel.dryrun", ["--platform", platform],
                         timeout, os.path.dirname(os.path.dirname(os.path.dirname(
                             os.path.abspath(__file__)))))
    return json.loads(outs[0].strip().splitlines()[-1])


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--devices", default="1", help="comma-separated device counts")
    p.add_argument("--platform", default="cuda", choices=["cpu", "cuda"])
    p.add_argument("--worker", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.worker:
        report = _worker(args.worker, args.rank, args.port, args.platform)
        if args.rank == 0:
            print(json.dumps(report))
        return report
    reports = []
    for n in (int(x) for x in args.devices.split(",")):
        t0 = time.perf_counter()
        report = dryrun_multichip(n, args.platform)
        report["wall_s"] = time.perf_counter() - t0
        print(json.dumps(report), flush=True)
        reports.append(report)
    return reports


if __name__ == "__main__":
    main()
