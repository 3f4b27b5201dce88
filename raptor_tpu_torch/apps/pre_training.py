"""CLI: SAC teacher pre-training.

Counterpart of `raptor_tpu/apps/pre_training.py`, with every flag of it plus
`--device` (default `cuda`; it raises where there is no card). Two modes:

- airframes from files (one teacher per JSON):
    python -m raptor_tpu_torch.apps.pre_training dynamics_parameters/7.json
- population mode, K teachers on freshly sampled airframes as one program:
    python -m raptor_tpu_torch.apps.pre_training --population 128 --steps-per-call 10 \\
        --replay-capacity 1536 --sample-rows

Teacher checkpoints land in the run directory
(`<experiments-dir>/<experiment>/<timestamp>_pre_training/checkpoints/
<step>_teacher{i}.h5`, or `.npz` where h5py is not installed) with each
teacher's airframe beside it (`..._teacher{i}_dynamics.json`), and the
manifest `checkpoints.txt` lists them for `apps.post_training`.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import os
import time

import torch

from raptor_tpu_torch.checkpoint import h5 as ckpt_h5
from raptor_tpu_torch.device import resolve_device
from raptor_tpu_torch.distill import population
from raptor_tpu_torch.env import EnvConfig, L2F
from raptor_tpu_torch.env.io import load_params_json, params_to_dict, save_params_json
from raptor_tpu_torch.env.types import tree_map
from raptor_tpu_torch.rl import sac
from raptor_tpu_torch.utils.extrack import Run


def export_teachers(run, states, airframes, n_teachers, final_step):
    """Export every teacher's actor and its airframe JSON and write the
    `checkpoints.txt` manifest; returns the manifest's path.

    The whole stacked population is pulled to the host first (one copy per
    tensor) and sliced in numpy. Called periodically during training, so a
    run that is killed still leaves a complete, slightly stale population on
    disk. Every file (actors, airframes, manifest) is written to a `.tmp`
    path and `os.replace`d, so a kill in the middle of a write never leaves a
    truncated file that a still-valid manifest names."""
    suffix = ".h5" if importlib.util.find_spec("h5py") else ".npz"
    host_actor = {"layers": [{k: v.detach().cpu().numpy() for k, v in layer.items()}
                             for layer in states.sac.actor["layers"]]}
    host_airframes = tree_map(lambda x: x.detach().cpu(), airframes)
    manifest = []
    for i in range(n_teachers):
        actor_i = {"layers": [{k: v[i] for k, v in layer.items()}
                              for layer in host_actor["layers"]]}
        path = run.checkpoint_path(final_step, f"_teacher{i}{suffix}")
        ckpt_h5.save_mlp_actor(path + ".tmp", actor_i, meta={"teacher_index": i},
                               npz=suffix == ".npz")
        os.replace(path + ".tmp", path)
        frame_path = path[: -len(suffix)] + "_dynamics.json"
        save_params_json(frame_path + ".tmp", tree_map(lambda x: x[i:i + 1], host_airframes))
        os.replace(frame_path + ".tmp", frame_path)
        manifest.append(path)
    manifest_path = os.path.join(run.dir, "checkpoints.txt")
    tmp = manifest_path + ".tmp"
    with open(tmp, "w") as f:
        f.write("\n".join(manifest) + "\n")
    os.replace(tmp, manifest_path)
    return manifest_path


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("dynamics_json", nargs="*", help="airframe JSON file(s)")
    p.add_argument("--population", type=int, default=0,
                   help="sample K fresh airframes instead of reading JSONs")
    p.add_argument("--envs-per-teacher", type=int, default=32)
    p.add_argument("--super-steps", type=int, default=200)
    p.add_argument("--steps-per-call", type=int, default=1,
                   help="super-steps run per call of the step function (logging, "
                        "evaluation and checkpoint cadence coarsen with it)")
    p.add_argument("--unroll-inner", action=argparse.BooleanOptionalAction, default=True,
                   help="accepted for the JAX CLI's sake: eager PyTorch runs the inner "
                        "super-steps as a Python loop either way")
    p.add_argument("--replay-capacity", type=int, default=4096,
                   help="replay ring rows per teacher (device memory: K x capacity x envs "
                        "x 68 floats)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--experiments-dir", default="experiments")
    p.add_argument("--eval-every", type=int, default=20)
    p.add_argument("--log-every", type=int, default=10,
                   help="pull training metrics to the host every N calls (each pull "
                        "waits for the device)")
    p.add_argument("--compute-dtype", default=None, choices=[None, "bfloat16"],
                   help="learner matmul operands: bfloat16 rounds them (forward and "
                        "backward) with f32 accumulation; master weights and optimizer "
                        "stay f32; default f32 throughout")
    p.add_argument("--stack-critics", action=argparse.BooleanOptionalAction, default=False,
                   help="twin critics as one batched matmul per layer (the same numbers)")
    p.add_argument("--flat-optim", action=argparse.BooleanOptionalAction, default=False,
                   help="multi-tensor Adam updates (the same arithmetic)")
    p.add_argument("--init-angle-power", type=float, default=1.0,
                   help="init-severity curriculum for teacher training: start attitude "
                        "angle = max_angle * u^(1/p); p > 1 oversamples severe starts")
    p.add_argument("--angular-velocity-weight", type=float, default=None,
                   help="override RewardConfig.angular_velocity_weight for teacher "
                        "training only (recovery shaping); students are still evaluated "
                        "on the standard reward")
    p.add_argument("--action-weight", type=float, default=None,
                   help="override RewardConfig.action_weight for teacher training")
    p.add_argument("--sample-rows", action=argparse.BooleanOptionalAction, default=False,
                   help="row-contiguous replay sampling: minibatch = batch/n_envs random "
                        "whole time rows instead of scattered (time, env) pairs")
    p.add_argument("--demo-seed-steps", type=int, default=0,
                   help="run N scripted-demonstrator collect super-steps after the random "
                        "warm-up, so critics see the fast flip's value from step 0. Pair "
                        "with --init-angle-power so the demonstrations start severe")
    p.add_argument("--demo-every", type=int, default=0,
                   help="additionally run one demonstrator collect every N calls (0 = off)")
    p.add_argument("--demo-adaptive", action="store_true",
                   help="per-airframe adaptive demonstrator gain caps")
    p.add_argument("--checkpoint-every", type=int, default=500,
                   help="also export the full teacher population every N calls "
                        "(overwrites in place); 0 = final export only")
    p.add_argument("--device", default="cuda")
    return p


def main(argv=None, return_summary: bool = False):
    """Train the teachers; returns the manifest's path, or with
    `return_summary` (path, a dict of the logged metrics, evaluations and the
    seconds per call). The calls are timed, each between two device
    synchronizations, only for that summary: a plain run never waits for the
    device except where it pulls metrics."""
    parser = _parser()
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    base = EnvConfig()
    rw = base.reward
    if args.angular_velocity_weight is not None:
        rw = dataclasses.replace(rw, angular_velocity_weight=args.angular_velocity_weight)
    if args.action_weight is not None:
        rw = dataclasses.replace(rw, action_weight=args.action_weight)
    env = L2F(EnvConfig(
        init=dataclasses.replace(base.init, angle_power=args.init_angle_power), reward=rw))
    generator = torch.Generator(device=device).manual_seed(args.seed)

    if args.population:
        airframes = population.sample_teacher_airframes(generator, args.population)
        n_teachers = args.population
    else:
        if not args.dynamics_json:
            parser.error("pass dynamics JSON files or --population K")
        frames = [load_params_json(f, device) for f in args.dynamics_json]
        airframes = tree_map(lambda *xs: torch.cat(xs), *frames)
        n_teachers = len(frames)

    pop_cfg = population.PopulationConfig(
        n_teachers=n_teachers,
        envs_per_teacher=args.envs_per_teacher,
        replay_capacity=args.replay_capacity,
        sample_rows=args.sample_rows,
    )
    sac_cfg = sac.SACConfig(
        compute_dtype=args.compute_dtype,
        stack_critics=args.stack_critics,
        flat_optim=args.flat_optim,
    )
    states, env_params, run_cfg = population.population_init(
        generator, env, airframes, pop_cfg, sac_cfg)
    warmup = population.make_population_warmup(env, run_cfg)
    if args.steps_per_call > 1:
        super_step = population.make_population_multi_step(
            env, run_cfg, sac_cfg, args.steps_per_call, unroll=args.unroll_inner)
    else:
        super_step = population.make_population_super_step(env, run_cfg, sac_cfg)
    evaluator = population.make_population_eval(env, 8, env.EPISODE_LENGTH)

    run = Run(base_dir=args.experiments_dir, name="pre_training")
    host_frames = tree_map(lambda x: x.cpu(), airframes)
    run.snapshot_config({
        "pop_cfg": pop_cfg, "sac_cfg": sac_cfg, "seed": args.seed, "device": str(device),
        "airframes": [params_to_dict(tree_map(lambda x: x[i:i + 1], host_frames))
                      for i in range(min(n_teachers, 8))],
    })

    demo_collect = None
    if args.demo_seed_steps or args.demo_every:
        demo_collect = population.make_population_demo_collect(
            env, run_cfg, adaptive=args.demo_adaptive)

    def timed_now():
        """The host clock once the device is idle (for the summary only)."""
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter()

    for _ in range(pop_cfg.warmup_super_steps):
        states = warmup(states, env_params)
    for _ in range(args.demo_seed_steps):
        states = demo_collect(states, env_params)
    env_steps_per = run_cfg.rollout_length * run_cfg.n_envs * args.steps_per_call
    final_step = args.super_steps * env_steps_per
    logged, evaluations, seconds = [], [], []
    for i in range(args.super_steps):
        if return_summary:
            t0 = timed_now()
        states, metrics = super_step(states, env_params)
        if return_summary:
            seconds.append(timed_now() - t0)
        if args.demo_every and (i + 1) % args.demo_every == 0:
            states = demo_collect(states, env_params)
        step = (i + 1) * env_steps_per
        if args.log_every and (i + 1) % args.log_every == 0:
            scalars = {
                "critic_loss/mean": float(metrics.critic_loss.mean()),
                "actor_loss/mean": float(metrics.actor_loss.mean()),
                "alpha/mean": float(metrics.alpha.mean()),
            }
            run.log(scalars, step)
            logged.append({"step": step, **scalars})
        if args.eval_every and (i + 1) % args.eval_every == 0:
            # the same evaluation episodes every time
            eval_gen = torch.Generator(device=device).manual_seed(args.seed + 1)
            stats = evaluator(states.sac, airframes, eval_gen)
            scalars = {
                "evaluation/return/mean": float(stats.return_mean.mean()),
                "evaluation/return/std": float(stats.return_std.mean()),
                "evaluation/episode_length/mean": float(stats.episode_length_mean.mean()),
                "evaluation/share_terminated": float(stats.share_terminated.mean()),
            }
            run.log(scalars, step)
            evaluations.append({"step": step, **scalars})
        if args.checkpoint_every and (i + 1) % args.checkpoint_every == 0:
            export_teachers(run, states, airframes, n_teachers, final_step)

    manifest_path = export_teachers(run, states, airframes, n_teachers, final_step)
    run.close()
    print(f"teachers: {n_teachers}  manifest: {manifest_path}")
    summary = {
        "manifest": manifest_path, "teachers": n_teachers, "device": str(device),
        "env_steps_per_call_per_teacher": env_steps_per, "seconds_per_call": seconds,
        "metrics": logged, "evaluations": evaluations,
    }
    return (manifest_path, summary) if return_summary else manifest_path


if __name__ == "__main__":
    main()
