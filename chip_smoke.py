#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (`raptor_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA Hopper card
(sm_90a) and the CUDA toolkit. Phases, in order; any failure ends the run
with a non-zero exit code and no result line:

1. the card's name and power limit (nvidia-smi);
2. build the CUDA kernels from `raptor_tpu_torch/csrc/` (nvcc, one process per
   source, in parallel) and print ptxas' register and spill counts;
3. rollout kernel vs its plain PyTorch version on N = 16,384 random airframes:
   20 steps with termination off (atol 2e-4, rtol 1e-3 on every state field),
   then 512 steps at hover with default bounds (finite, |q| = 1 +- 1e-5);
4. eval kernel vs its plain version on N = 16,384, default init, 25 steps with
   the committed student: alive and length agree on >= 99.9% of envs; on
   those, return within atol 5e-3 / rtol 1e-3 and position within atol 1e-3;
5. the serving main path with every launch count set to 0: the evaluate CLI
   with `--fused` (N = 2,048 x 8 = 16,384 envs, 500 steps, eval-parity init)
   must give share_terminated <= 0.05 and mean episode length >= 480, and the
   rollout entry point (N = 16,384, 512 steps at hover) must stay finite; each
   kernel must have launched;
6. collect kernel vs its plain version with the committed student, on three
   populations: N = 16,384 random airframes, the 5,528 envs of the committed
   691-teacher union and the 944 envs of one distillation round (the widths
   the main paths give it, neither a multiple of 32). On each: (a) gentle
   starts inside wide bounds, 20 steps: reset masks equal and all zero,
   observations within atol 2e-4; (b) episode length 8, default bounds, 20
   steps: reset masks equal on >= 99.9% of entries, rows 7 and 15 reset on
   > 90% of envs, rows after a reset inside the init position range with zero
   previous action and an orthonormal R (atol 1e-4); (c) episode length 1, 10
   steps, every row a fresh draw of the in-kernel PRNG: observations within
   atol 1e-5;
7. the collect main path with launch counts from 0: the collect benchmark CLI
   on the committed 691-teacher union (691 x 8 = 5,528 envs, 500 steps) must
   report `parity_ok` and finite labels in [-1, 1] and launch the collect
   kernel; prints the eager and the fused seconds per round;
8. the training main path with launch counts from 0: the distillation CLI on
   the same union with the full recipe's flags, cut in depth only (2 rounds of
   8 gradient steps, 118 teachers x 8 envs a round): every loss finite, the
   final checkpoint loads and passes its self-test, the round-hook evaluation
   gives five finite statistics; prints the launch counts read right after it
   (the distillation loop collects and evaluates eagerly, so it launches no
   kernel), and the seconds per collect round and per gradient step. Then,
   outside the counted runs, the evaluate CLI flies the trained student
   through the eval kernel, and one collect round of the trained student
   through the collect kernel at the round's shape (944 envs) feeds the
   aggregate and one gradient step;
9. time each kernel and its plain version at the main-path shapes (CUDA
   events, median of 5 after a warm-up; 3 for the collect's plain version)
   and print one `{"kernels": [...]}` line with the launches of phases 5 and
   7, error, times and the bound;
10. last line: {"ok": true, "device": {...}}.

It imports neither JAX nor the JAX package. Without a CUDA device, or without
the `raptor_tpu_torch` package beside it, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
N = 16_384
T_ROLLOUT = 512
T_EVAL = 500
T_COLLECT = 500
ENVS_PER_TEACHER = 8
STUDENT = os.path.join(ROOT, "raptor_tpu_torch", "data", "student_rateFlagCurMix.npz")
UNION = os.path.join(ROOT, "experiments", "union_cur691_packs.txt")
# the full recipe's flags (docs/MIGRATION.md section 7), cut in depth only
RECIPE = [
    "--envs-per-teacher", "8", "--teachers-per-round", "118", "--aggregate-capacity", "40960",
    "--teacher-mix-rounds", "3", "--collect-angle-power", "4", "--demo-tilt", "1.2",
    "--demo-rate", "5.0", "--demo-adaptive", "--demo-w-cap", "999", "--demo-k-w", "999",
    "--demo-c-flip", "0.5", "--demo-c-lag", "1.2", "--demo-c-bw", "3.0",
]
DEPTH = ["--rounds", "2", "--grad-steps-per-round", "8", "--eval-every-rounds", "2"]

# FP32 operations per env-step, counted from csrc/quad_step.cuh (each add,
# sub, mul, div, sqrt and compare is one): derivative 210, so RK4 = 4 x 210 +
# 3 stage updates (34 + 68 + 68) + combination 51 + renormalize 13 + rpm clip
# 8 = 1,082; termination 20.
FLOPS_ROLLOUT_STEP = 1_082 + 20
# eval adds observation 30, Dense 22->16 + ReLU 720, GRU 16 x (16 x 12) = 3,072
# plus gates 16 x 15 = 240, Dense 16->4 + clip 136, setpoints 28, reward 42,
# accumulators 2; its 48 expf/tanhf per env-step run on the special-function
# unit, which the peak table below does not rate, and are not counted.
FLOPS_EVAL_STEP = FLOPS_ROLLOUT_STEP + 30 + 720 + 3_072 + 240 + 136 + 28 + 42 + 2
# collect is eval without reward and accumulators, plus the truncation test and
# step count (3); a reset adds 14 hashed uniforms (13 integer operations and 3
# float each), 7 Box-Muller pairs (6 each, their log/sqrt/sin/cos not
# counted), the quaternion and scalings (30) and the hover speed (15).
FLOPS_COLLECT_STEP = FLOPS_EVAL_STEP - 42 - 2 + 3
FLOPS_COLLECT_RESET = 14 * 16 + 7 * 6 + 30 + 15

# Published peaks (NVIDIA data sheets, dense, at the full power limit):
# (FP32 FLOP/s outside the tensor cores, device-memory bytes/s).
PEAKS = {
    "H100 SXM": (67e12, 3.35e12),
    "H100 NVL": (60e12, 3.9e12),
    "H100 PCIe": (51e12, 2.0e12),
}


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    return 1


def peaks_for(name: str):
    if "NVL" in name:
        return "H100 NVL", PEAKS["H100 NVL"]
    if "PCIe" in name:
        return "H100 PCIe", PEAKS["H100 PCIe"]
    return "H100 SXM", PEAKS["H100 SXM"]


def check_close(what, got, want, atol, rtol):
    """Raise unless |got - want| <= atol + rtol |want|; return max |got - want|."""
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    if bool(bad.any()):
        raise AssertionError(
            f"{what}: {int(bad.sum())} values outside atol {atol} rtol {rtol}, "
            f"max abs err {float(err.max()):.3e}"
        )
    return float(err.max())


def time_ms(torch, fn, reps: int = 5) -> float:
    """Median over `reps` runs of fn() on the card (CUDA events), after one
    warm-up run."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false")
    if not os.path.isfile(os.path.join(ROOT, "raptor_tpu_torch", "__init__.py")):
        return fail(f"no raptor_tpu_torch package beside {__file__}")
    sys.path.insert(0, ROOT)

    from raptor_tpu_torch.apps import bench_collect as bench_collect_cli
    from raptor_tpu_torch.apps import evaluate as evaluate_cli
    from raptor_tpu_torch.apps import post_training as post_training_cli
    from raptor_tpu_torch.checkpoint import from_numpy, h5
    from raptor_tpu_torch.distill import post_training as distill
    from raptor_tpu_torch.distill.population import broadcast_airframe_to_envs, flatten_envs
    from raptor_tpu_torch.env import (
        EnvConfig, InitConfig, L2F, TerminationConfig, dynamics, eval_parity_init,
    )
    from raptor_tpu_torch.env.randomization import sample_population
    from raptor_tpu_torch.env.types import tree_map
    from raptor_tpu_torch.ops import build
    from raptor_tpu_torch.ops import collect as ops_collect
    from raptor_tpu_torch.ops import eval as ops_eval
    from raptor_tpu_torch.ops import rollout as ops_rollout
    from raptor_tpu_torch.rl import networks

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, check=False,
    )
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed")
    kind = torch.cuda.get_device_name(0)
    print(f"torch device: {kind}")
    dev = torch.device("cuda", 0)
    sku, (peak_flops, peak_bytes) = peaks_for(kind)

    # 2. build
    t0 = time.perf_counter()
    build.cuda_library()
    print(f"build: {time.perf_counter() - t0:.1f} s")
    for line in build.cuda_build_log().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"ptxas: {line.strip()}")

    # 3. rollout kernel vs plain
    g = torch.Generator(device=dev).manual_seed(0)
    frames = sample_population(g, N)
    env = L2F(EnvConfig())
    es, _ = env.reset(frames, g)
    ps, ss = frames.to_soa(), es.dynamics.to_soa()
    action = torch.tensor([0.1, -0.05, 0.02, 0.0], device=dev)[:, None].expand(4, N).contiguous()
    off = dict(pos_bound=1e9, linvel_bound=1e9, angvel_bound=1e9)
    k_out, k_stats = ops_rollout.rollout_soa(ps, ss, action, 20, **off)
    p_out, p_stats = ops_rollout.rollout_plain(ps, ss, action, 20, **off)
    torch.cuda.synchronize()
    if not bool((k_stats == p_stats).all()) or not bool((k_stats[0] == 1).all()):
        raise AssertionError("rollout: alive/length differ with termination off")
    rollout_err = 0.0
    for name, rows in (("position", (0, 3)), ("orientation", (3, 7)),
                       ("linear_velocity", (7, 10)), ("angular_velocity", (10, 13)),
                       ("rpm", (13, 17))):
        rollout_err = max(rollout_err, check_close(
            f"rollout {name}", k_out[rows[0]:rows[1]], p_out[rows[0]:rows[1]], 2e-4, 1e-3))
    print(f"rollout: kernel vs plain, 20 steps, max abs err {rollout_err:.3e}")
    hover = dynamics.hover_action(frames)[None].expand(4, N).contiguous()
    h_out, h_stats = ops_rollout.rollout_soa(ps, ss, hover, T_ROLLOUT)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(h_out).all()):
        raise AssertionError("rollout: non-finite state after 512 steps at hover")
    qn = torch.linalg.norm(h_out[3:7], dim=0)
    check_close("rollout |q|", qn, torch.ones_like(qn), 1e-5, 0.0)
    print(f"rollout: 512 steps at hover, alive {float(h_stats[0].mean()):.4f}, finite, |q| = 1")

    # 4. eval kernel vs plain
    policy = from_numpy(h5.load_actor(STUDENT), dev)
    weights = ops_eval.flatten_policy(policy)
    k_out, k_stats = ops_eval.eval_soa(weights, ps, ss, 25)
    p_out, p_stats = ops_eval.eval_plain(policy, ps, ss, 25)
    torch.cuda.synchronize()
    agree = (k_stats[0] == p_stats[0]) & (k_stats[1] == p_stats[1])
    n_agree = int(agree.sum())
    print(f"eval: alive and length agree on {n_agree}/{N} envs ({N - n_agree} flipped)")
    if n_agree < 0.999 * N:
        raise AssertionError(f"eval: alive/length agree on only {n_agree}/{N} envs")
    eval_err = max(
        check_close("eval return", k_stats[2][agree], p_stats[2][agree], 5e-3, 1e-3),
        check_close("eval position", k_out[0:3][:, agree], p_out[0:3][:, agree], 1e-3, 0.0),
    )
    print(f"eval: kernel vs plain, 25 steps, max abs err (return, position) {eval_err:.3e}")

    # 5. the serving main path, with launch counts from 0
    ops_eval.launches = ops_rollout.launches = ops_collect.launches = 0
    t0 = time.perf_counter()
    stats = evaluate_cli.main([
        STUDENT, "--fused", "--n-airframes", str(N // 8), "--envs-per-airframe", "8",
        "--episode-length", str(T_EVAL), "--eval-parity-init", "--device", "cuda",
    ])
    print(f"main path: evaluate CLI wall {time.perf_counter() - t0:.3f} s")
    r_state, r_alive, r_len = ops_rollout.fused_rollout(
        frames, es.dynamics, hover.T, T_ROLLOUT, device=dev)
    torch.cuda.synchronize()
    launches = {"eval": ops_eval.launches, "rollout": ops_rollout.launches}
    print(f"main path launches: {launches}")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the main path never launched: {launches}")
    if not (stats["share_terminated"] <= 0.05 and stats["episode_length/mean"] >= 480):
        raise AssertionError(f"main path eval below the bar: {stats}")
    if not all(bool(torch.isfinite(t).all()) for t in (r_state.to_soa(), r_alive, r_len)):
        raise AssertionError("main path rollout: non-finite output")

    # 6. collect kernel vs plain, at a full-warp width and at the two widths
    # the main paths give it (5,528 and 944 envs, 24 and 16 past a multiple
    # of 32: a partly filled last warp and an unaligned channel stride)
    gen = torch.Generator(device=dev).manual_seed(3)
    teacher_actors, airframes = post_training_cli.load_teachers(UNION, dev)
    env_params = broadcast_airframe_to_envs(airframes, ENVS_PER_TEACHER)
    round_idx = torch.randperm(airframes.mass.shape[0], generator=gen, device=dev)[:118]
    sub_params = tree_map(lambda x: x[round_idx], env_params)
    gentle = EnvConfig(
        init=InitConfig(max_angle=0.2, linear_velocity_std=0.02, angular_velocity_std=0.02),
        termination=TerminationConfig(position_bound=50.0, angular_velocity_bound=1000.0))
    short = EnvConfig(episode_length=8)
    every = EnvConfig(episode_length=1)

    def check_collect(pop):
        """Checks (a)-(c) on the airframes `pop`; returns the largest
        observation error of (a) and (c)."""
        n_pop = pop.mass.shape[0]
        pop_ps = pop.to_soa()
        pop_ss = L2F(EnvConfig()).sample_state(pop, g).to_soa()

        def collect_both(config, n_steps, seed, state_soa):
            got = ops_collect.collect_soa(weights, pop_ps, state_soa, n_steps, seed, 0, config)
            want = ops_collect.collect_plain(policy, pop_ps, state_soa, n_steps, seed, 0, config)
            torch.cuda.synchronize()
            return got, want

        gentle_ss = L2F(gentle).sample_state(pop, g).to_soa()
        (k_obs, k_reset), (p_obs, p_reset) = collect_both(gentle, 20, 3, gentle_ss)
        if k_obs.shape != (20, n_pop, 22) or k_reset.shape != (20, n_pop):
            raise AssertionError(f"collect (a): shapes {k_obs.shape} {k_reset.shape}")
        if not bool((k_reset == p_reset).all()) or float(p_reset.sum()) != 0.0:
            raise AssertionError("collect (a): reset masks differ or an env reset")
        err_a = check_close("collect (a) obs", k_obs, p_obs, 2e-4, 0.0)

        (k_obs, k_reset), (p_obs, p_reset) = collect_both(short, 20, 11, pop_ss)
        same = float((k_reset == p_reset).float().mean())
        if same < 0.999 or float(k_reset[7].mean()) <= 0.9 or float(k_reset[15].mean()) <= 0.9:
            raise AssertionError(
                f"collect (b): reset masks agree on {same:.5f}, rows 7 and 15 reset on "
                f"{float(k_reset[7].mean()):.3f} and {float(k_reset[15].mean()):.3f}")
        after = torch.cat([k_obs[8][k_reset[7] == 1.0], k_obs[16][k_reset[15] == 1.0]])
        rot = after[:, 3:12].reshape(-1, 3, 3)
        check_close("collect (b) R R^T", rot @ rot.transpose(1, 2),
                    torch.eye(3, device=dev).expand_as(rot), 1e-4, 0.0)
        if (float(after[:, 0:3].abs().max()) > short.init.position_range + 1e-6
                or float(after[:, 18:22].abs().max()) != 0.0):
            raise AssertionError("collect (b): a row after a reset is not a fresh start")

        (k_obs, k_reset), (p_obs, p_reset) = collect_both(every, 10, 5, pop_ss)
        if float(k_reset.min()) != 1.0 or float(p_reset.min()) != 1.0:
            raise AssertionError("collect (c): an env did not reset at every step")
        err_c = check_close("collect (c) obs", k_obs, p_obs, 1e-5, 0.0)
        print(f"collect, {n_pop} envs: (a) 20 steps without resets, max abs err {err_a:.3e}; "
              f"(b) episode length 8, reset masks agree on {same:.5f} of entries, "
              f"{after.shape[0]} fresh rows inside the init box; (c) every row a fresh draw, "
              f"max abs err {err_c:.3e}")
        return max(err_a, err_c)

    collect_err = max(
        check_collect(pop) for pop in (frames, flatten_envs(env_params), flatten_envs(sub_params)))

    # 7. the collect main path, with launch counts from 0
    ops_eval.launches = ops_rollout.launches = ops_collect.launches = 0
    t0 = time.perf_counter()
    report = bench_collect_cli.main([UNION, "--device", "cuda"])
    print(f"main path: collect benchmark CLI wall {time.perf_counter() - t0:.3f} s")
    launches["collect"] = ops_collect.launches
    print(f"collect main path launches: {ops_collect.launches}; eager "
          f"{report['eager_collect_s']:.4f} s/round, kernel + relabel "
          f"{report['fused_collect_s']:.4f} s/round "
          f"({report['env_steps_per_round']} env-steps a round)")
    if ops_collect.launches < 1:
        raise AssertionError("the collect kernel never launched on the collect main path")
    if not (report["parity_ok"] and report["labels_finite_in_unit_box"]):
        raise AssertionError(f"collect main path: {report}")

    # 8. the training main path, with launch counts from 0. The distillation
    # loop collects through the eager path and evaluates through the eager
    # evaluation, so the counts read after it say which kernels it reached.
    ops_eval.launches = ops_rollout.launches = ops_collect.launches = 0
    with tempfile.TemporaryDirectory() as exp_dir:
        t0 = time.perf_counter()
        ckpt, summary = post_training_cli.main(
            [UNION, *RECIPE, *DEPTH, "--experiments-dir", exp_dir, "--device", "cuda"],
            return_summary=True)
        print(f"main path: distillation CLI wall {time.perf_counter() - t0:.3f} s")
        print(f"training main path launches: collect {ops_collect.launches}, eval "
              f"{ops_eval.launches}, rollout {ops_rollout.launches}")
        self_test = h5.verify_checkpoint(ckpt)
        trained = from_numpy(h5.load_actor(ckpt), dev)
        # not the training path: the checkpoint it wrote is served by the
        # evaluate CLI through the eval kernel
        ops_eval.launches = 0
        flown = evaluate_cli.main([
            ckpt, "--fused", "--n-airframes", "256", "--envs-per-airframe", "8",
            "--episode-length", str(T_EVAL), "--eval-parity-init", "--device", "cuda"])
        if ops_eval.launches < 1:
            raise AssertionError("the evaluate CLI flew the trained student past the eval kernel")
    losses = summary["loss_history"]
    if len(losses) != 2 or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"training main path: losses {losses}")
    (hooked,) = summary["evaluations"]
    five = [hooked[f"evaluation/{k}"] for k in (
        "return/mean", "return/std", "episode_length/mean", "episode_length/std",
        "share_terminated")]
    flown_five = [flown[k] for k in (
        "return/mean", "return/std", "episode_length/mean", "episode_length/std",
        "share_terminated")]
    if not all(math.isfinite(x) for x in five + flown_five):
        raise AssertionError(f"training main path: evaluation {hooked} {flown}")
    secs = summary["seconds"]
    n_grad = summary["grad_steps_per_round"]
    print(f"training: losses {losses}, self-test max err {self_test:.2e}, round-hook "
          f"evaluation (return mean/std, length mean/std, share terminated) {five}")
    print(f"training: seconds per round: collect {secs['collect']}, aggregate add "
          f"{secs['aggregate_add']}, {n_grad} gradient steps {secs['train']} "
          f"({[x / n_grad for x in secs['train']]} s per gradient step)")

    # 8b. the collect kernel's output trains (outside the counted runs: its
    # launch is not added to the `kernels` line): one round of the trained
    # student at the round's shape into the aggregate, then one gradient step
    env_c = L2F(EnvConfig(init=InitConfig(angle_power=4.0)))
    cfg = distill.DistillConfig(
        envs_per_teacher=ENVS_PER_TEACHER, rollout_length=T_COLLECT, aggregate_capacity=40_960,
        grad_steps_per_round=1, teachers_per_round=118)
    for layer in trained.values():
        for t in layer.values():
            t.requires_grad_(True)
    before = {k: v.detach().clone() for k, v in trained["dense_2"].items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    data = distill.fused_collect_round(
        trained, networks.take_actors(teacher_actors, round_idx), sub_params, gen, env_c, cfg,
        distill.make_relabel(env_c))
    torch.cuda.synchronize()
    t_fused = time.perf_counter() - t0
    agg = distill.make_aggregate_add(cfg)(distill.aggregate_init(cfg, dev), data, gen)
    train_round, optim_init = distill.make_train_from_aggregate(cfg)
    _, _, fused_losses = train_round(trained, optim_init(trained), agg, gen)
    torch.cuda.synchronize()
    print(f"collect kernel + relabel round of {data.obs.shape[1]} envs {t_fused:.4f} s, resets "
          f"{float(data.reset.mean()):.5f} of rows, loss of the gradient step on it "
          f"{float(fused_losses[0]):.5f}")
    if not bool(torch.isfinite(fused_losses).all()) or agg.size != data.obs.shape[1]:
        raise AssertionError("training on the collect kernel's output failed")
    if all(bool(torch.equal(before[k], trained["dense_2"][k].detach())) for k in before):
        raise AssertionError("the gradient step on the collect kernel's output changed nothing")

    # 9. timing at the main-path shapes
    g_frames = torch.Generator(device=dev).manual_seed(0)
    m_frames = tree_map(lambda x: x.repeat_interleave(8, 0), sample_population(g_frames, N // 8))
    m_env = L2F(EnvConfig(init=eval_parity_init()))
    m_es, _ = m_env.reset(m_frames, torch.Generator(device=dev).manual_seed(1))
    m_ps, m_ss = m_frames.to_soa(), m_es.dynamics.to_soa()

    c_ps = flatten_envs(env_params).to_soa()
    c_ss = L2F(EnvConfig()).sample_state(flatten_envs(env_params), gen).to_soa()
    n_c = c_ps.shape[1]

    rows = []
    specs = (
        ("rollout", "raptor_tpu_torch/csrc/rollout.cu", "raptor_tpu/ops/pallas_rollout.py:200",
         lambda: ops_rollout.rollout_soa(ps, ss, hover, T_ROLLOUT),
         lambda: ops_rollout.rollout_plain(ps, ss, hover, T_ROLLOUT),
         FLOPS_ROLLOUT_STEP, (42 + 17 + 4 + 17 + 2) * 4 * N, rollout_err),
        ("eval", "raptor_tpu_torch/csrc/eval.cu", "raptor_tpu/ops/pallas_eval.py:130",
         lambda: ops_eval.eval_soa(weights, m_ps, m_ss, T_EVAL),
         lambda: ops_eval.eval_plain(policy, m_ps, m_ss, T_EVAL),
         FLOPS_EVAL_STEP, (42 + 17 + 17 + 3) * 4 * N + ops_eval.N_WEIGHTS * 4, eval_err),
        ("collect", "raptor_tpu_torch/csrc/collect.cu", "raptor_tpu/ops/pallas_collect.py:252",
         lambda: ops_collect.collect_soa(weights, c_ps, c_ss, T_COLLECT, 0),
         lambda: ops_collect.collect_plain(policy, c_ps, c_ss, T_COLLECT, 0),
         FLOPS_COLLECT_STEP,
         (42 + 17) * 4 * n_c + ops_eval.N_WEIGHTS * 4 + 23 * 4 * n_c * T_COLLECT, collect_err),
    )
    for name, source, replaces, kernel, plain, flops_step, n_bytes, err in specs:
        if name == "collect":
            # every env runs every step; a reset adds its fresh sample
            env_steps = float(n_c * T_COLLECT)
            n_resets = float(kernel()[1].sum())
            extra_ops = FLOPS_COLLECT_RESET * n_resets
        else:
            # threads leave the loop when their env dies: count the env-steps run
            env_steps = float(kernel()[1][1].sum())
            extra_ops = 0.0
        ms = time_ms(torch, kernel)
        plain_ms = time_ms(torch, plain, reps=3 if name == "collect" else 5)
        t_ops = (flops_step * env_steps + extra_ops) / peak_flops * 1e3
        t_bytes = n_bytes / peak_bytes * 1e3
        rows.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None,
        })
        print(f"{name}: kernel {ms:.3f} ms, plain {plain_ms:.1f} ms, bound {max(t_ops, t_bytes):.4f} ms "
              f"({env_steps:.0f} env-steps, {sku} peaks)")
    # at hover most rollout envs crash within ~50 steps and their threads leave
    # the loop; with termination off every env runs all 512 steps
    off_ms = time_ms(torch, lambda: ops_rollout.rollout_soa(ps, ss, hover, T_ROLLOUT, **off))
    off_bound = FLOPS_ROLLOUT_STEP * N * T_ROLLOUT / peak_flops * 1e3
    print(f"rollout, termination off: kernel {off_ms:.3f} ms, bound {off_bound:.4f} ms "
          f"({N * T_ROLLOUT} env-steps, {sku} peaks)")

    # the wrapper hands out obs [T, N, 22] as a view of the kernel's
    # channel-major buffer; a caller that needs it dense pays this transpose
    c_obs = ops_collect.collect_soa(weights, c_ps, c_ss, T_COLLECT, 0)[0]
    dense_ms = time_ms(torch, lambda: c_obs.contiguous())
    print(f"collect: obs.contiguous() of [{T_COLLECT}, {n_c}, 22] {dense_ms:.3f} ms "
          f"(not on the main path)")

    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
