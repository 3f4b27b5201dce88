"""CLI: distillation post-training. Reads a teacher population (a `.npz`
teacher pack, a manifest of packs, or a `checkpoints.txt` manifest of
per-teacher `.h5` or `.npz` actor files with their `_dynamics.json`), distills the GRU student
across it, logs the tfevents tags `loss`, `evaluation/*`, `crazyflie/*`, and
exports the student with golden example I/O.

Counterpart of `raptor_tpu/apps/post_training.py`, with every flag of it plus
`--device` (default `cuda`; it raises where there is no card):

    python -m raptor_tpu_torch.apps.post_training experiments/union_cur691_packs.txt --rounds 40
    python -m raptor_tpu_torch.apps.post_training pack.npz --rounds 2 --device cpu

Checkpoints are written in the reference HDF5 schema where `h5py` is
installed, else in the `.npz` form of it (`checkpoint/h5.py`); both load with
`checkpoint.h5.load_actor`. The run directory also gets `summary.json`: the
final checkpoint, the loss history, the evaluations and the seconds each
round spent in collect, aggregate add and training.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import os

import numpy as np
import torch

from raptor_tpu_torch.apps.pack_teachers import load_teacher_pack
from raptor_tpu_torch.checkpoint import h5 as ckpt_h5
from raptor_tpu_torch.checkpoint import teachers_from_numpy
from raptor_tpu_torch.device import resolve_device
from raptor_tpu_torch.distill import post_training
from raptor_tpu_torch.env import EnvConfig, L2F, eval_parity_init, presets
from raptor_tpu_torch.env.io import _FIELDS, load_params_numpy
from raptor_tpu_torch.env.types import tree_map
from raptor_tpu_torch.ops import bptt as ops_bptt
from raptor_tpu_torch.ops import build
from raptor_tpu_torch.rl import evaluation
from raptor_tpu_torch.utils.extrack import Run


def _dynamics_json(checkpoint_path: str) -> str:
    return checkpoint_path[: checkpoint_path.rindex(".")] + "_dynamics.json"


def _load_actor_group(paths):
    """Per-teacher actor files (`.h5` or `.npz`) and their `_dynamics.json`,
    stacked."""
    actors = [ckpt_h5.load_mlp_actor(p) for p in paths]
    frames = [load_params_numpy(_dynamics_json(p)) for p in paths]
    layers = [
        {k: np.stack([a["layers"][i][k] for a in actors]) for k in ("w", "b")}
        for i in range(len(actors[0]["layers"]))
    ]
    airframes = {f: np.stack([fr[f] for fr in frames]) for f in _FIELDS}
    return {"layers": layers}, airframes


def load_teachers(manifest_path: str, device="cuda"):
    """A teacher population on `device`, as (stacked [K] actor dict,
    `DynamicsParams` [K]), from any of:

    - a `.npz` teacher pack (apps.pack_teachers),
    - a `checkpoints.txt` manifest of per-teacher actor files (`.h5`, or
      the `.npz` form `apps.pre_training` writes where h5py is missing),
    - a manifest whose lines are `.npz` packs, or a mix of packs and actor
      files: the populations concatenate along the K axis in line order.
    """
    device = resolve_device(device)
    if manifest_path.endswith(".npz"):
        return teachers_from_numpy(*load_teacher_pack(manifest_path), device)
    with open(manifest_path) as f:
        paths = [line.strip() for line in f if line.strip()]
    if not paths:
        raise ValueError(
            f"teacher manifest {manifest_path!r} is empty: it must list .h5 checkpoints "
            "and/or .npz teacher packs, one per line"
        )
    # one group per pack and per run of consecutive h5 lines, so the K-axis
    # teacher order is the manifest's line order
    groups, h5_run = [], []
    for p in paths:
        if p.endswith(".npz") and not ckpt_h5.is_mlp_actor_npz(p):
            if h5_run:
                groups.append(_load_actor_group(h5_run))
                h5_run = []
            groups.append(load_teacher_pack(p))
        else:
            h5_run.append(p)
    if h5_run:
        groups.append(_load_actor_group(h5_run))
    n_layers = len(groups[0][0]["layers"])
    actors = {
        "layers": [
            {k: np.concatenate([g[0]["layers"][i][k] for g in groups]) for k in ("w", "b")}
            for i in range(n_layers)
        ]
    }
    airframes = {f: np.concatenate([g[1][f] for g in groups]) for f in _FIELDS}
    return teachers_from_numpy(actors, airframes, device)


def evaluate_student(env, student, airframes, generator, n_envs_per=8, episode_length=None):
    """Aggregate 5-stat eval of the recurrent student across airframes."""
    params = tree_map(lambda x: x.repeat_interleave(n_envs_per, 0), airframes)
    m = params.mass.shape[0]
    step_fn, carry = evaluation.gru_policy_step(student, m)
    with torch.no_grad():
        return evaluation.evaluate(env, params, step_fn, carry, generator, m, episode_length)


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("manifest", help="teacher pack (.npz) or manifest (.txt)")
    p.add_argument("--rounds", type=int, default=40)
    p.add_argument("--envs-per-teacher", type=int, default=8)
    p.add_argument("--epochs-per-round", type=int, default=2)
    p.add_argument("--teacher-mix-initial", type=float, default=1.0)
    p.add_argument("--teacher-mix-final", type=float, default=0.0)
    p.add_argument("--teacher-mix-rounds", type=int, default=10)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--learning-rate", type=float, default=1e-3)
    p.add_argument("--aggregate-capacity", type=int, default=0,
                   help="DAgger dataset reservoir size in sequences "
                        "(0 = train on the latest round only)")
    p.add_argument("--grad-steps-per-round", type=int, default=0,
                   help="minibatch updates per round from the aggregate")
    p.add_argument("--teachers-per-round", type=int, default=0,
                   help="collect from a random subset of K teachers each round (0 = all)")
    p.add_argument("--standardize", action="store_true",
                   help="fit an observation normalizer on the round-0 teacher-driven data "
                        "(frozen afterwards) and fold it into the exported student (exact)")
    p.add_argument("--diagnostics", action="store_true",
                   help="log per-round loss decomposition (diagnostics/* tags)")
    p.add_argument("--lr-final-scale", type=float, default=0.05,
                   help="cosine LR floor as a fraction of peak LR")
    p.add_argument("--eval-max-angle", type=float, default=0.0,
                   help="eval-parity InitConfig.max_angle for evaluation/* and crazyflie/* "
                        "tags (0 = use the training init)")
    p.add_argument("--collect-angle-power", type=float, default=1.0,
                   help="init-severity curriculum for the collect: start attitude angle = "
                        "pi * u^(1/p); p > 1 oversamples near-pi starts")
    p.add_argument("--demo-tilt", type=float, default=0.0,
                   help="collect states tilted beyond this angle (rad) get labels from the "
                        "scripted recovery controller instead of the teacher. 0 = off")
    p.add_argument("--demo-rate", type=float, default=0.0,
                   help="extend the demo-label criterion to tilt > --demo-tilt OR |w| > this "
                        "(rad/s). 0 = tilt-only")
    p.add_argument("--demo-rollout-frac", type=float, default=0.0,
                   help="fraction of each teacher's collect envs executed by the scripted "
                        "demonstrator for the whole run")
    p.add_argument("--demo-w-cap", type=float, default=10.0,
                   help="demonstrator rate cap (999 + --demo-adaptive = physics-pure "
                        "per-airframe caps)")
    p.add_argument("--demo-k-w", type=float, default=30.0,
                   help="demonstrator rate-PD gain ceiling")
    p.add_argument("--demo-c-flip", type=float, default=1.0,
                   help="adaptive cap: flip-authority coefficient")
    p.add_argument("--demo-c-lag", type=float, default=0.8,
                   help="adaptive cap: motor-lag arrest coefficient")
    p.add_argument("--demo-c-bw", type=float, default=1.5,
                   help="adaptive cap: rate-loop bandwidth coefficient")
    p.add_argument("--demo-adaptive", action="store_true",
                   help="per-airframe adaptive demonstrator gain caps for demo labels and "
                        "demo-driven envs")
    p.add_argument("--severe-weight", type=float, default=1.0,
                   help="BPTT loss weight on frames tilted past --severe-tilt "
                        "(weight-normalized; 1.0 = off)")
    p.add_argument("--severe-tilt", type=float, default=1.2,
                   help="tilt threshold (rad) for --severe-weight")
    p.add_argument("--student-hidden", type=int, default=16,
                   help="student GRU width; 16 = reference architecture (2,084 params). "
                        "Other widths are a capacity ablation, not reference-parity; on a "
                        "card only the widths the BPTT kernels are built for, "
                        f"{', '.join(map(str, build.HIDDEN_WIDTHS))}")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--experiments-dir", default="experiments")
    p.add_argument("--eval-every-rounds", type=int, default=5)
    p.add_argument("--device", default="cuda")
    return p


def main(argv=None, return_summary: bool = False):
    """Run the distillation; returns the final checkpoint's path, or with
    `return_summary` (path, the dict written to `summary.json`)."""
    args = _parser().parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        ops_bptt.require_built(args.student_hidden)

    env = L2F(EnvConfig(init=dataclasses.replace(
        EnvConfig().init, angle_power=args.collect_angle_power)))
    fullinit_env = L2F(EnvConfig()) if args.collect_angle_power != 1.0 else env
    teacher_actors, airframes = load_teachers(args.manifest, device)
    total_grad = args.grad_steps_per_round * args.rounds
    cfg = post_training.DistillConfig(
        envs_per_teacher=args.envs_per_teacher,
        epochs_per_round=args.epochs_per_round,
        rollout_length=env.EPISODE_LENGTH,
        teacher_mix_initial=args.teacher_mix_initial,
        teacher_mix_final=args.teacher_mix_final,
        teacher_mix_decay_rounds=args.teacher_mix_rounds,
        batch_size=args.batch_size,
        learning_rate=args.learning_rate,
        aggregate_capacity=args.aggregate_capacity,
        grad_steps_per_round=args.grad_steps_per_round,
        total_grad_steps=total_grad if args.aggregate_capacity else 0,
        lr_final_scale=args.lr_final_scale,
        teachers_per_round=args.teachers_per_round,
        standardize=args.standardize,
        diagnostics=args.diagnostics,
        student_hidden=args.student_hidden,
        demo_tilt=args.demo_tilt,
        demo_rate=args.demo_rate,
        demo_rollout_frac=args.demo_rollout_frac,
        demo_adaptive=args.demo_adaptive,
        demo_w_cap=args.demo_w_cap,
        demo_k_w=args.demo_k_w,
        demo_c_flip=args.demo_c_flip,
        demo_c_lag=args.demo_c_lag,
        demo_c_bw=args.demo_c_bw,
        severe_weight=args.severe_weight,
        severe_tilt=args.severe_tilt,
    )
    run = Run(base_dir=args.experiments_dir, name="post_training")
    run.snapshot_config({"cfg": cfg, "seed": args.seed, "manifest": args.manifest,
                         "device": str(device)})
    suffix = ".h5" if importlib.util.find_spec("h5py") else ".npz"

    # held-out airframe (the `crazyflie/*` tags)
    crazyflie = presets.crazyflie(device)

    # evaluation/* and crazyflie/* use the eval-parity init when
    # --eval-max-angle is given; fullinit/* then keeps the uniform-to-pi init
    if args.eval_max_angle > 0:
        eval_env = L2F(EnvConfig(init=dataclasses.replace(
            eval_parity_init(), max_angle=args.eval_max_angle)))
    else:
        eval_env = env

    def eval_generator():
        # the same evaluation episodes at every round
        return torch.Generator(device=device).manual_seed(args.seed + 1)

    seconds, evaluations = {}, []

    def log_fn(tag, value, step):
        run.writer.scalar(tag, value, step)
        if tag.startswith("seconds/"):
            seconds.setdefault(tag[len("seconds/"):], []).append(value)

    def round_hook(r, student, env_steps):
        if (r + 1) % args.eval_every_rounds:
            return
        stats = evaluate_student(eval_env, student, airframes, eval_generator())
        cf = evaluate_student(eval_env, student, crazyflie, eval_generator(), n_envs_per=16)
        scalars = {
            "evaluation/return/mean": float(stats.return_mean),
            "evaluation/return/std": float(stats.return_std),
            "evaluation/episode_length/mean": float(stats.episode_length_mean),
            "evaluation/episode_length/std": float(stats.episode_length_std),
            "evaluation/share_terminated": float(stats.share_terminated),
            "crazyflie/return/mean": float(cf.return_mean),
            "crazyflie/episode_length/mean": float(cf.episode_length_mean),
            "crazyflie/share_terminated": float(cf.share_terminated),
        }
        if eval_env is not env:
            # fullinit/* stays on the uniform-to-pi init whatever the
            # --collect-angle-power curriculum, so the tag compares across runs
            fstats = evaluate_student(fullinit_env, student, airframes, eval_generator())
            scalars.update({
                "fullinit/return/mean": float(fstats.return_mean),
                "fullinit/episode_length/mean": float(fstats.episode_length_mean),
                "fullinit/share_terminated": float(fstats.share_terminated),
            })
        run.log(scalars, env_steps)
        evaluations.append({"round": r, "env_steps": env_steps, **scalars})
        ckpt_h5.save_actor(run.checkpoint_path(env_steps, suffix), student,
                           checkpoint_name=run.name)

    student, history = post_training.distill(
        torch.Generator(device=device).manual_seed(args.seed),
        env, teacher_actors, airframes, cfg,
        n_rounds=args.rounds, log_fn=log_fn, round_hook=round_hook,
    )

    final_path = os.path.join(run.checkpoint_dir, "final" + suffix)
    ckpt_h5.save_actor(final_path, student, checkpoint_name=run.name)
    err = ckpt_h5.verify_checkpoint(final_path)
    run.close()
    summary = {
        "checkpoint": final_path, "self_test_max_err": err, "device": str(device),
        "loss_history": history, "evaluations": evaluations, "seconds": seconds,
        "grad_steps_per_round": args.grad_steps_per_round,
    }
    with open(os.path.join(run.dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(f"student: {final_path}  self-test max-err: {err:.2e}  "
          f"final loss: {history[-1]:.4f}")
    return (final_path, summary) if return_summary else final_path


if __name__ == "__main__":
    main()
