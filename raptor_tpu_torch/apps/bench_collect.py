"""CLI: time one DAgger collect round through the eager path
(`distill.post_training.make_collect` at beta = 0) and through the collect
kernel with the batched relabel pass (`fused_collect_round`), and gate the
kernel's parity against the eager environment.

Counterpart of `raptor_tpu/apps/bench_collect.py`, with the same report keys
(`xla_collect_*` there are `eager_collect_*` here). On the card each path is
timed with CUDA events around whole rounds, after one warm-up round; with
`--device cpu` the host clock is used and the fused path runs the kernel's
plain version, so its time says nothing about the kernel.

    python -m raptor_tpu_torch.apps.bench_collect experiments/union_cur691_packs.txt
    python -m raptor_tpu_torch.apps.bench_collect --synthetic 4 --rollout-length 20 --device cpu
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from raptor_tpu_torch.apps.post_training import load_teachers
from raptor_tpu_torch.device import resolve_device
from raptor_tpu_torch.distill import post_training
from raptor_tpu_torch.distill.population import (
    broadcast_airframe_to_envs,
    sample_teacher_airframes,
)
from raptor_tpu_torch.env import EnvConfig, InitConfig, L2F, TerminationConfig
from raptor_tpu_torch.env.types import tree_map
from raptor_tpu_torch.ops.collect import make_fused_collect
from raptor_tpu_torch.policy import network as student_net
from raptor_tpu_torch.rl import networks

# the parity gate: gentle starts and wide bounds, so no env resets early on
PARITY_CONFIG = EnvConfig(
    init=InitConfig(max_angle=0.2, linear_velocity_std=0.02, angular_velocity_std=0.02),
    termination=TerminationConfig(position_bound=50.0, angular_velocity_bound=1000.0),
)
PARITY_ENVS = 1024
PARITY_STEPS = 100


def time_rounds(fn, device: torch.device, reps: int) -> float:
    """Mean seconds of fn() over `reps` runs after one warm-up run: CUDA
    events on the card, the host clock on the CPU."""
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(device)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e-3 / reps


@torch.no_grad()
def parity_check(student, airframes, device: torch.device) -> dict:
    """The fused collect against the eager env + policy loop from the same
    1,024 initial states. Gated on one full closed-loop step (row 1: obs ->
    GRU -> action -> RK4 -> obs), which has no feedback amplification; the
    100-step difference is reported for information only, since a random
    policy tumbles chaotically and two correct f32 implementations diverge."""
    env = L2F(PARITY_CONFIG)
    k = airframes.mass.shape[0]
    base = max(1, min(k, PARITY_ENVS))
    reps = -(-PARITY_ENVS // base)
    params = tree_map(lambda x: x[:base].repeat_interleave(reps, 0)[:PARITY_ENVS], airframes)
    gen = torch.Generator(device=device).manual_seed(9)
    es, obs = env.reset(params, gen)
    obs_f, reset_f = make_fused_collect(student, PARITY_STEPS, PARITY_CONFIG, device)(
        params, es.dynamics, 3
    )
    h = student_net.initial_hidden(student, PARITY_ENVS)
    rows = []
    for _ in range(PARITY_STEPS):
        rows.append(obs[..., :22])
        h, a = student_net.apply_step(student, h, obs[..., :22])
        es, obs, _, _, _ = env.step(params, es, torch.clamp(a, -1.0, 1.0), gen)
    obs_e = torch.stack(rows)
    step1_err = float((obs_f[1] - obs_e[1]).abs().max())
    # only a reset in the first two rows could contaminate the gated step
    resets = float(reset_f[:2].sum())
    return {
        "parity_step1_err": step1_err,
        "trajectory_drift_100steps": float((obs_f - obs_e).abs().max()),
        "parity_resets_first2": resets,
        "parity_ok": bool(step1_err < 1e-4 and resets == 0.0),
    }


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("manifest", nargs="?", default=None,
                   help="teacher pack or manifest (omit with --synthetic)")
    p.add_argument("--synthetic", type=int, default=None, metavar="K",
                   help="benchmark with K randomly initialized teachers and sampled "
                        "airframes instead of a manifest (throughput and parity do not "
                        "depend on the weights)")
    p.add_argument("--envs-per-teacher", type=int, default=8)
    p.add_argument("--rollout-length", type=int, default=500)
    p.add_argument("--reps", type=int, default=2, help="timed rounds per path")
    p.add_argument("--out", default=None, help="JSON report path")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    env = L2F(EnvConfig())
    if args.synthetic is not None and args.synthetic <= 0:
        p.error(f"--synthetic needs a positive teacher count, got {args.synthetic}")
    if args.synthetic:
        airframes = sample_teacher_airframes(
            torch.Generator(device=device).manual_seed(7), args.synthetic)
        g8 = torch.Generator(device=device).manual_seed(8)
        teacher_actors = networks.stack_actors(
            [networks.actor_init(g8, env.OBSERVATION_DIM, 4) for _ in range(args.synthetic)])
    elif args.manifest:
        teacher_actors, airframes = load_teachers(args.manifest, device)
    else:
        p.error("provide a manifest or --synthetic K")
    k, m, t = airframes.mass.shape[0], args.envs_per_teacher, args.rollout_length
    n_env_steps = k * m * t
    cfg = post_training.DistillConfig(envs_per_teacher=m, rollout_length=t)
    env_params = broadcast_airframe_to_envs(airframes, m)
    student = student_net.init_params(torch.Generator(device=device).manual_seed(0))
    gen = torch.Generator(device=device).manual_seed(1)

    # eager path (beta = 0: student-driven, teachers label in the loop)
    collect = post_training.make_collect(env, cfg)
    eager_s = time_rounds(
        lambda: collect(student, teacher_actors, env_params, gen, 0.0), device, args.reps)

    # fused path (collect kernel + batched relabel)
    relabel = post_training.make_relabel(env)
    labels = []

    def fused():
        data = post_training.fused_collect_round(
            student, teacher_actors, env_params, gen, env, cfg, relabel, 0)
        labels[:] = [data.teacher_action]

    fused_s = time_rounds(fused, device, args.reps)
    lab = labels[0]
    labels_ok = bool(torch.isfinite(lab).all()) and float(lab.abs().max()) <= 1.0

    report = {
        **parity_check(student, airframes, device),
        "labels_finite_in_unit_box": labels_ok,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "teachers": k,
        "envs_per_teacher": m,
        "rollout_length": t,
        "env_steps_per_round": n_env_steps,
        "eager_collect_s": eager_s,
        "eager_collect_steps_per_s": n_env_steps / eager_s,
        "fused_collect_s": fused_s,
        "fused_collect_steps_per_s": n_env_steps / fused_s,
        "speedup": eager_s / fused_s,
    }
    print(json.dumps(report, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
    if not (report["parity_ok"] and labels_ok):
        raise SystemExit(2)  # the kernel must match the eager path
    return report


if __name__ == "__main__":
    main()
