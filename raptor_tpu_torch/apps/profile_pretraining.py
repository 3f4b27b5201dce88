"""CLI: profile the population pre-training super-step.

Counterpart of `raptor_tpu/apps/profile_pretraining.py`, with the same
variants and flags plus `--device` and `--roofline`. It measures the marginal
cost of a super-step (the difference between two call counts, each bracketed
by `torch.cuda.synchronize()`) for a grid of variants:

  - K-scaling: does doubling the population double the wall clock?
  - collect vs train split: which half dominates?
  - batch-size / gradient-steps shape at a fixed sample-reuse ratio, the
    fast-path learner options and row sampling.

    python -m raptor_tpu_torch.apps.profile_pretraining --out profile.json
    python -m raptor_tpu_torch.apps.profile_pretraining --flops-only --out profile.json \
        [--roofline roofline.json]

`--flops-only` counts the FLOPs of a super-step (`count_flops`) and places
every timed full-mode row of `--out` on the roofline: against the FP32 peak
of a `roofline.json` written by `apps.roofline` (it names its card), or, by
default, against the peak measured now on the card (`apps.roofline.
measure_fma_peak`). A variant that fails is printed as an `error` row and the
CLI exits non-zero after the report is written.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch
from torch.utils.flop_counter import FlopCounterMode

from raptor_tpu_torch.apps.roofline import FLOPS_ENV_STEP, card_name_and_power_limit
from raptor_tpu_torch.device import resolve_device

FLOP_COUNT_METHOD = (
    "matmuls (forward and backward) by torch.utils.flop_counter.FlopCounterMode over one "
    "sac_update and one actor_sample; the env step by the hand count of apps/roofline.py "
    "(FLOPS_ENV_STEP an env-step); left out: the elementwise work of the networks, the "
    "losses, the replay sampling and Adam")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time_marginal(fn, state0, n_lo: int, n_hi: int, device: torch.device):
    """fn: state -> state. Returns (seconds a call, final state): the extra
    time of n_hi calls over n_lo calls, after one warm-up call."""
    s = fn(state0)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(n_lo):
        s = fn(s)
    _sync(device)
    t1 = time.perf_counter()
    for _ in range(n_hi):
        s = fn(s)
    _sync(device)
    t2 = time.perf_counter()
    return ((t2 - t1) - (t1 - t0)) / (n_hi - n_lo), s


def profile_variant(
    name: str,
    n_teachers: int,
    envs_per_teacher: int = 32,
    rollout_length: int = 16,
    gradient_steps: int = 16,
    batch_size: int = 256,
    replay_capacity: int = 1536,
    steps_per_call: int = 10,
    mode: str = "full",  # full | collect | train
    unroll: bool = False,
    sample_rows: bool = False,
    n_lo: int = 1,
    n_hi: int = 4,
    sac_kwargs: dict | None = None,
    device="cuda",
) -> dict:
    from raptor_tpu_torch.distill import population
    from raptor_tpu_torch.env import EnvConfig, L2F
    from raptor_tpu_torch.rl import runner, sac

    device = resolve_device(device)
    env = L2F(EnvConfig())
    pop_cfg = population.PopulationConfig(
        n_teachers=n_teachers,
        envs_per_teacher=envs_per_teacher,
        rollout_length=rollout_length,
        gradient_steps=gradient_steps,
        batch_size=batch_size,
        replay_capacity=replay_capacity,
        warmup_super_steps=1,
        sample_rows=sample_rows,
    )
    sac_cfg = sac.SACConfig(**(sac_kwargs or {}))
    airframes = population.sample_teacher_airframes(
        torch.Generator(device=device).manual_seed(0), n_teachers)
    states, env_params, run_cfg = population.population_init(
        torch.Generator(device=device).manual_seed(1), env, airframes, pop_cfg, sac_cfg)
    states = population.make_population_warmup(env, run_cfg)(states, env_params)

    if mode == "full":
        step = population.make_population_multi_step(
            env, run_cfg, sac_cfg, steps_per_call, unroll=unroll)

        def fn(s):
            return step(s, env_params)[0]
    elif mode == "collect":

        def fn(s):
            for _ in range(steps_per_call):
                s = runner.collect(s, env, env_params, run_cfg)
            return s
    elif mode == "train":

        def fn(s):
            for _ in range(steps_per_call):
                s, _ = runner.train(s, run_cfg, sac_cfg)
            return s
    else:
        raise ValueError(mode)

    per_call, _ = _time_marginal(fn, states, n_lo, n_hi, device)
    per_super_step = per_call / steps_per_call
    env_steps = n_teachers * envs_per_teacher * rollout_length
    # a 30.7M-env-steps/teacher wave needs this many super-steps:
    wave_super_steps = 30.7e6 / (envs_per_teacher * rollout_length)
    return {
        "variant": name,
        "mode": mode,
        "teachers": n_teachers,
        "envs_per_teacher": envs_per_teacher,
        "rollout_length": rollout_length,
        "gradient_steps": gradient_steps,
        "batch_size": batch_size,
        "steps_per_call": steps_per_call,
        "s_per_super_step": per_super_step,
        "env_steps_per_s": env_steps / per_super_step,
        "teacher_env_steps_per_s_per_teacher": (
            envs_per_teacher * rollout_length / per_super_step
        ),
        "wave_30M_wall_clock_h": per_super_step * wave_super_steps / 3600,
        "teachers_per_hour_at_30M": (
            n_teachers / (per_super_step * wave_super_steps / 3600)
        ),
    }


def count_flops(
    envs_per_teacher: int = 32,
    rollout_length: int = 16,
    gradient_steps: int = 16,
    batch_size: int = 256,
    device="cpu",
) -> dict:
    """FLOPs of one super-step per teacher: G SAC gradient updates of
    `batch_size` and H collect steps of `envs_per_teacher` envs, each counted
    once and scaled by its trip count (see FLOP_COUNT_METHOD for what is
    counted)."""
    from raptor_tpu_torch.env import EnvConfig, L2F, sample_population
    from raptor_tpu_torch.rl import networks, sac

    device = resolve_device(device)
    env = L2F(EnvConfig())
    sac_cfg = sac.SACConfig()
    obs_dim, act_dim = env.OBSERVATION_DIM, 4
    gen = torch.Generator(device=device).manual_seed(0)
    state = sac.sac_init(gen, obs_dim, act_dim, sac_cfg)
    zeros = lambda *shape: torch.zeros(shape, device=device)  # noqa: E731
    batch = (zeros(batch_size, obs_dim), zeros(batch_size, act_dim), zeros(batch_size),
             zeros(batch_size, obs_dim), zeros(batch_size))
    with FlopCounterMode(display=False) as counter:
        sac.sac_update(state, gen, batch, sac_cfg)
    grad_flops = float(counter.get_total_flops())

    _, obs0 = env.reset(sample_population(gen, envs_per_teacher), gen)
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        networks.actor_sample(state.actor, obs0, gen)
    collect_flops = float(counter.get_total_flops()) + envs_per_teacher * FLOPS_ENV_STEP

    return {
        "grad_step_flops": grad_flops,
        "collect_step_flops": collect_flops,
        "gradient_steps": gradient_steps,
        "rollout_length": rollout_length,
        "flops_per_super_step_per_teacher": (
            gradient_steps * grad_flops + rollout_length * collect_flops),
        "method": FLOP_COUNT_METHOD,
    }


def place_on_roofline(report: dict, flops: dict, peak_flops_per_s: float) -> None:
    """Achieved TFLOP/s and the share of the FP32 peak of every timed
    full-mode row of `report`, in place."""
    for r in report.get("rows", []):
        if r.get("mode") == "full" and "s_per_super_step" in r:
            total = flops["flops_per_super_step_per_teacher"] * r["teachers"]
            r["achieved_tflops"] = total / r["s_per_super_step"] / 1e12
            r["vpu_f32_roofline_fraction"] = total / r["s_per_super_step"] / peak_flops_per_s


def read_peak(path: str) -> tuple:
    """(FP32 peak FLOP/s, card) from a roofline.json of `apps.roofline`,
    which must name the card it was measured on."""
    with open(path) as f:
        peak = json.load(f).get("vpu_peak") or {}
    if not peak.get("fma_peak_flops_per_s") or not peak.get("card"):
        raise ValueError(f"{path}: no FP32 peak measured on a card")
    return peak["fma_peak_flops_per_s"], peak["card"]


VARIANTS = [
    ("k128_full", dict(n_teachers=128)),
    ("k256_full", dict(n_teachers=256)),
    ("k128_collect_only", dict(n_teachers=128, mode="collect")),
    ("k128_train_only", dict(n_teachers=128, mode="train")),
    # same sample-reuse ratio (batch x gsteps const), half the steps
    ("k128_batch512_g8", dict(n_teachers=128, batch_size=512, gradient_steps=8)),
    ("k128_spc40", dict(n_teachers=128, steps_per_call=40)),
    ("k128_unroll10", dict(n_teachers=128, unroll=True)),
    # bf16-rounded matmul operands alone
    ("k128_bf16_unroll10", dict(
        n_teachers=128, unroll=True,
        sac_kwargs=dict(compute_dtype="bfloat16"))),
    # op-count reducers alone (numerically identical to the f32 baseline)
    ("k128_stackflat_unroll10", dict(
        n_teachers=128, unroll=True,
        sac_kwargs=dict(stack_critics=True, flat_optim=True))),
    # everything on
    ("k128_fastpath_unroll10", dict(
        n_teachers=128, unroll=True,
        sac_kwargs=dict(compute_dtype="bfloat16", stack_critics=True,
                        flat_optim=True))),
    # row-contiguous replay sampling: a batch of whole time rows in place of
    # element gathers
    ("k128_rowsample_unroll10", dict(
        n_teachers=128, unroll=True, sample_rows=True)),
    ("k128_rowsample_fastpath_unroll10", dict(
        n_teachers=128, unroll=True, sample_rows=True,
        sac_kwargs=dict(stack_critics=True, flat_optim=True))),
    ("k128_rowsample_train_only", dict(
        n_teachers=128, mode="train", sample_rows=True)),
    ("k128_rowsample_bf16_unroll10", dict(
        n_teachers=128, unroll=True, sample_rows=True,
        sac_kwargs=dict(compute_dtype="bfloat16"))),
    # K geometry under row sampling
    ("k256_rowsample_unroll10", dict(
        n_teachers=256, unroll=True, sample_rows=True)),
    ("k512_rowsample_unroll10", dict(
        n_teachers=512, unroll=True, sample_rows=True,
        replay_capacity=1024)),
    ("k128_rowsample_collect_only", dict(
        n_teachers=128, mode="collect", sample_rows=True)),
]


def run_variants(names, device="cuda", **overrides) -> dict:
    """Profile the named variants (each with `overrides` on top of its own
    settings) into one report; a variant that raises becomes an `error`
    row."""
    device = resolve_device(device)
    rows = []
    for name, kw in VARIANTS:
        if name not in names:
            continue
        print(f"profiling {name} ...", flush=True)
        try:
            row = profile_variant(name, **{**kw, **overrides}, device=device)
        except Exception as e:  # noqa: BLE001 (reported, and the CLI exits non-zero)
            row = {"variant": name, "error": f"{type(e).__name__}: {e}"}
        rows.append(row)
        print(json.dumps(row), flush=True)

    report = {"platform": device.type,
              "card": card_name_and_power_limit() if device.type == "cuda" else None,
              "rows": rows}
    full = {r["variant"]: r for r in rows if "s_per_super_step" in r}
    if "k128_full" in full and "k256_full" in full:
        report["k_scaling_cost_ratio"] = (
            full["k256_full"]["s_per_super_step"]
            / full["k128_full"]["s_per_super_step"]
        )
    if "k128_full" in full and "k128_collect_only" in full and \
            "k128_train_only" in full:
        t = full["k128_full"]["s_per_super_step"]
        report["collect_share"] = full["k128_collect_only"]["s_per_super_step"] / t
        report["train_share"] = full["k128_train_only"]["s_per_super_step"] / t
    return report


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--variants", default=None,
                   help="comma-separated subset of variant names")
    p.add_argument("--flops-only", action="store_true",
                   help="only count the FLOPs of a super-step and merge them, with the "
                        "roofline placement of every timed full-mode row, into --out")
    p.add_argument("--roofline", default=None,
                   help="roofline.json of apps.roofline whose measured FP32 peak places "
                        "the rows; default: measure the peak on the card now")
    p.add_argument("--out", default=None, help="JSON report path")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    if args.flops_only:
        report = {}
        if args.out and os.path.exists(args.out):
            with open(args.out) as f:
                report = json.load(f)
        flops = count_flops(device=device)
        report["flops"] = flops
        timed = [r for r in report.get("rows", []) if "s_per_super_step" in r]
        if timed:
            if args.roofline:
                peak, card = read_peak(args.roofline)
            else:
                from raptor_tpu_torch.apps.roofline import measure_fma_peak

                if device.type != "cuda":
                    raise ValueError("the FP32 peak is measured on a card: pass --roofline")
                measured = measure_fma_peak(device=device)
                peak, card = measured["fma_peak_flops_per_s"], measured["card"]
            report["peak"] = {"fma_peak_flops_per_s": peak, "card": card}
            place_on_roofline(report, flops, peak)
        print(json.dumps(report, indent=2))
        if args.out:
            with open(args.out, "w") as f:
                json.dump(report, f, indent=2)
        return report

    names = set(args.variants.split(",")) if args.variants else {n for n, _ in VARIANTS}
    report = run_variants(names, device)
    print(json.dumps(report, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
    if any("error" in r for r in report["rows"]):
        sys.exit(1)
    return report


if __name__ == "__main__":
    main()
