"""Throughput benchmark of the port on one GPU.

    python -m raptor_tpu_torch.bench [--small] [--device cuda] [--train-grad-steps N]

Counterpart of the JAX package's root `bench.py`, with the same sub-metric
names (the roofline and baseline tools read them by name), the same shapes and
the same JSON line: {"metric", "value", "unit", "vs_baseline", "detail"}.

- fused_pallas_rollout: the fused rollout kernel (`ops/rollout.py`), the whole
  T-step RK4 rollout of N airframes under a constant action (headline value);
- fused_policy_eval:    the closed-loop eval kernel (`ops/eval.py`): GRU policy
  + dynamics + reward + termination, whole episodes in the kernel, with the
  in-repo student `data/student_rateFlagCurMix.npz`;
- full_env_step_xla:    the full eager `env.step` (dynamics + reward +
  termination + auto-reset) in a Python loop (the name is the JAX bench's);
- train_env_steps_per_s: distillation throughput: student collect + teacher
  labels + BPTT gradient steps, env-steps per second of wall clock including
  training (K 128 x 8 envs, T 500, 183 gradient steps a round);
- pretrain_env_steps_per_s: the SAC teacher-farm super-step at the production
  wave configuration (K 128 teachers x 32 envs, replay capacity 1,536,
  row-contiguous sampling, 10 inner super-steps a call).

Each sub-bench runs in its own subprocess (`--sub <name>`), one after the
other, so each is alone on the card and a failure or a timeout degrades that
metric to null instead of ending the bench. Every rate is the marginal cost
between two iteration counts, each timed on the host clock after
`torch.cuda.synchronize()`, so fixed per-batch overhead cancels.
`detail.launches` holds, for each sub-bench, how often each kernel wrapper
launched its kernels in the timed iterations (`utils.profiling.launches`,
set to 0 after the warm-up): on a card the rollout sub-bench launches the
rollout kernel 50 times, the eval sub-bench the eval kernel 25 times, and the
distillation sub-bench the BPTT kernels 3 times a gradient step; the other two
run eager PyTorch and launch none.

The rollout and eval kernels leave the loop of an env that terminated, so N x
T a call would count steps that never ran. The rollout sub-bench therefore
runs with the termination bounds off (every env runs all T steps, the work
the JAX bench's kernel does, and it checks that every env did), and the eval
sub-bench counts the env-steps its kernel reports as run.

`--small` runs tiny shapes for smoke tests of the plumbing; with `--device
cpu` the kernels' plain versions run, and the numbers say nothing about any
device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REFERENCE_STEPS_PER_S = 10_580.0  # the reference's post-training run (BASELINE.md)
N_ENVS = 16384
N_STEPS = 512
EVAL_STEPS = 500  # reference episode length
TRAIN_GRAD_STEPS = 183
STUDENT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                       "student_rateFlagCurMix.npz")

# (name, timeout_s): a timeout degrades the metric to null
SUBBENCHES = [
    ("fused_pallas_rollout", 300),
    ("fused_policy_eval", 300),
    ("full_env_step_xla", 600),
    ("train_env_steps_per_s", 2400),
    ("pretrain_env_steps_per_s", 900),
]


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _warm(device) -> None:
    """End of a sub-bench's warm-up: wait for the device and set the launch
    tally to 0, so the counts a sub-bench reports are those of its timed
    iterations."""
    from raptor_tpu_torch.utils.profiling import reset_launches

    _sync(device)
    reset_launches()


def _marginal(timed, lo: int, hi: int, work_per_iter: float) -> float:
    """work/s from the extra time of `hi` over `lo` iterations."""
    t_lo, t_hi = timed(lo), timed(hi)
    return work_per_iter * (hi - lo) / max(t_hi - t_lo, 1e-9)


def _env_and_pop(device, n_envs):
    import torch

    from raptor_tpu_torch.env import EnvConfig, L2F, sample_population

    env = L2F(EnvConfig())
    generator = torch.Generator(device=device).manual_seed(0)
    params = sample_population(generator, n_envs)
    es, _ = env.reset(params, generator)
    return env, params, es, generator


def bench_fused_pallas_rollout(device, small, _args):
    from raptor_tpu_torch.env import dynamics
    from raptor_tpu_torch.ops import rollout as ops_rollout

    n_envs, n_steps = (256, 64) if small else (N_ENVS, N_STEPS)
    _, params, es, _ = _env_and_pop(device, n_envs)
    pp, sp = params.to_soa(), es.dynamics.to_soa()
    ap = dynamics.hover_action(params)[None].expand(4, n_envs).contiguous()
    off = dict(pos_bound=1e9, linvel_bound=1e9, angvel_bound=1e9)
    ops_rollout.rollout_soa(pp, sp, ap, n_steps, **off)  # warm: builds the kernels
    _warm(device)
    ran = []

    def timed(iters):
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(iters):
            # from the same initial states every call: fed back, the unbounded
            # tumbling states overflow after a few thousand steps
            _, stats = ops_rollout.rollout_soa(pp, sp, ap, n_steps, **off)
        _sync(device)
        ran.append(stats)
        return time.perf_counter() - t0

    rate = _marginal(timed, 10, 40, n_envs * n_steps)
    if not all(bool((s[0] == 1).all()) and bool((s[1] == n_steps).all()) for s in ran):
        raise RuntimeError("an env left the rollout early: N x T would overstate the work")
    return rate


def bench_fused_policy_eval(device, small, _args):
    """Closed loop: the in-repo GRU student + env, whole episodes in the kernel."""
    from raptor_tpu_torch.checkpoint import from_numpy, h5
    from raptor_tpu_torch.ops.eval import make_fused_policy_eval

    n_envs, n_steps = (256, 32) if small else (N_ENVS, EVAL_STEPS)
    _, params, es, _ = _env_and_pop(device, n_envs)
    policy = from_numpy(h5.load_actor(STUDENT), device)
    run = make_fused_policy_eval(policy, n_steps, device=device)
    # the same inputs every call, so every call runs these env-steps
    steps_run = float(run(params, es.dynamics)[2].sum())
    _warm(device)

    def timed(iters):
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(iters):
            run(params, es.dynamics)
        _sync(device)
        return time.perf_counter() - t0

    return _marginal(timed, 5, 20, steps_run)


def bench_full_env_step_xla(device, small, _args):
    import torch

    n_envs, n_steps = (256, 64) if small else (N_ENVS, N_STEPS)
    env, params, es0, generator = _env_and_pop(device, n_envs)
    action = torch.zeros((n_envs, 4), device=device)

    @torch.no_grad()
    def rollout(es):
        r_sum = torch.zeros((), device=device)
        for _ in range(n_steps):
            es, _, r, _, _ = env.step(params, es, action, generator)
            r_sum = r_sum + r.sum()
        return es, r_sum

    rollout(es0)
    _warm(device)

    def timed(iters):
        _sync(device)
        t0 = time.perf_counter()
        e = es0
        for _ in range(iters):
            e, r = rollout(e)
        float(r)
        return time.perf_counter() - t0

    return _marginal(timed, 2, 8, n_envs * n_steps)


def bench_train_env_steps_per_s(device, small, args):
    """Distillation pipeline throughput: collect (student GRU + teacher
    labels over a [K, M] population) + aggregate add + BPTT minibatch gradient
    steps, as env-steps per second of total wall clock."""
    import torch

    from raptor_tpu_torch.distill import population, post_training
    from raptor_tpu_torch.env import EnvConfig, L2F
    from raptor_tpu_torch.policy import network as student_net
    from raptor_tpu_torch.rl import networks

    k, m, t, gsteps = (4, 4, 32, 4) if small else (128, 8, EVAL_STEPS, args.train_grad_steps)
    env = L2F(EnvConfig())
    cfg = post_training.DistillConfig(
        envs_per_teacher=m, rollout_length=t, batch_size=min(64, k * m),
        aggregate_capacity=4 * k * m, grad_steps_per_round=gsteps, total_grad_steps=0,
    )
    generator = torch.Generator(device=device).manual_seed(1)
    airframes = population.sample_teacher_airframes(generator, k)
    teachers = networks.actor_init(generator, env.OBSERVATION_DIM, 4, (64, 64), n_stack=k)
    env_params = population.broadcast_airframe_to_envs(airframes, m)
    student = student_net.init_params(generator)
    for layer in student.values():
        for leaf in layer.values():
            leaf.requires_grad_(True)
    collect = post_training.make_collect(env, cfg)
    add = post_training.make_aggregate_add(cfg)
    train, optim_init = post_training.make_train_from_aggregate(cfg)
    opt = optim_init(student)
    agg = post_training.aggregate_init(cfg, device)

    def one_round():
        nonlocal agg
        data = collect(student, teachers, env_params, generator, 0.5)
        agg = add(agg, data, generator)
        return train(student, opt, agg, generator)[2]

    one_round()
    _warm(device)

    def timed(rounds):
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(rounds):
            losses = one_round()
        float(losses.sum())
        return time.perf_counter() - t0

    return _marginal(timed, 1, 4, k * m * t)


def bench_pretrain_env_steps_per_s(device, small, _args):
    """SAC teacher-farm throughput (env-steps/s summed over the population) at
    the production wave configuration: the program `apps.pre_training
    --population 128 --steps-per-call 10 --replay-capacity 1536 --sample-rows`
    runs."""
    import torch

    from raptor_tpu_torch.distill import population
    from raptor_tpu_torch.env import EnvConfig, L2F
    from raptor_tpu_torch.rl import sac

    k, spc = (4, 2) if small else (128, 10)
    pop_cfg = population.PopulationConfig(
        n_teachers=k,
        envs_per_teacher=8 if small else 32,
        replay_capacity=64 if small else 1536,
        sample_rows=True,
    )
    sac_cfg = sac.SACConfig()
    env = L2F(EnvConfig())
    generator = torch.Generator(device=device).manual_seed(0)
    airframes = population.sample_teacher_airframes(generator, k)
    states, env_params, run_cfg = population.population_init(
        generator, env, airframes, pop_cfg, sac_cfg)
    warmup = population.make_population_warmup(env, run_cfg)
    super_step = population.make_population_multi_step(env, run_cfg, sac_cfg, spc)
    for _ in range(pop_cfg.warmup_super_steps):
        states = warmup(states, env_params)
    states, metrics = super_step(states, env_params)
    float(metrics.critic_loss.sum())
    _warm(device)

    def timed(iters):
        nonlocal states
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(iters):
            states, m = super_step(states, env_params)
        float(m.critic_loss.sum())
        return time.perf_counter() - t0

    return _marginal(timed, 2, 6, k * run_cfg.n_envs * run_cfg.rollout_length * spc)


# ------------------------------------------------------------ orchestration


def run_sub(name, timeout_s, extra_args):
    """Run one metric in its own subprocess: (value, kernel launches of its
    timed iterations), or (None, None) on any failure."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "raptor_tpu_torch.bench", "--sub", name, *extra_args],
            capture_output=True, text=True, timeout=timeout_s, cwd=root,
        )
    except subprocess.TimeoutExpired:
        return None, None
    if proc.returncode != 0:
        print(f"bench: sub-bench {name} failed:\n{proc.stderr[-2000:]}", file=sys.stderr)
        return None, None
    for line in reversed(proc.stdout.strip().splitlines()):
        try:
            out = json.loads(line)
            return out["value"], out["launches"]
        except (json.JSONDecodeError, KeyError, TypeError):
            continue
    return None, None


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--sub", default=None, help="run one sub-bench in this process")
    p.add_argument("--small", action="store_true", help="tiny shapes: a smoke test")
    p.add_argument("--device", default="cuda")
    p.add_argument("--train-grad-steps", type=int, default=TRAIN_GRAD_STEPS,
                   help="gradient steps a round of the distillation sub-bench "
                        "(183 is the production shape; fewer cuts its depth)")
    args = p.parse_args(argv)

    from raptor_tpu_torch.device import resolve_device

    device = resolve_device(args.device)
    if args.sub:
        fn = globals()["bench_" + args.sub]
        value = fn(device, args.small, args)
        from raptor_tpu_torch.utils.profiling import launches

        out = {"value": value, "launches": dict(launches)}
        print(json.dumps(out))
        return out

    from raptor_tpu_torch.apps.roofline import card_name_and_power_limit

    detail = {
        "n_envs": 256 if args.small else N_ENVS,
        "n_steps": 64 if args.small else N_STEPS,
        "small_smoke_mode": args.small,
        "device": str(device),
        "card": card_name_and_power_limit() if device.type == "cuda" else None,
        "train_grad_steps": 4 if args.small else args.train_grad_steps,
    }
    extra = ["--device", args.device, "--train-grad-steps", str(args.train_grad_steps)]
    if args.small:
        extra.append("--small")
    # kernel launches of each sub-bench's timed iterations, by wrapper
    detail["launches"] = {}
    for name, timeout_s in SUBBENCHES:
        v, detail["launches"][name] = run_sub(name, timeout_s, extra)
        detail[name] = None if v is None else round(v)

    headline = detail["fused_pallas_rollout"]
    closed_loop = detail["fused_policy_eval"]
    line = {
        "metric": "env-steps/s/chip (vectorized l2f step)",
        "value": headline,
        "unit": "env-steps/s",
        "vs_baseline": None if headline is None else round(headline / REFERENCE_STEPS_PER_S, 2),
        "detail": dict(
            detail, target_10M_closed_loop_met=bool(closed_loop and closed_loop >= 1e7)),
    }
    print(json.dumps(line))
    return line


if __name__ == "__main__":
    main()
