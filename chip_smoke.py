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
5. the main path with every launch count set to 0: the evaluate CLI with
   `--fused` (N = 2,048 x 8 = 16,384 envs, 500 steps, eval-parity init) must
   give share_terminated <= 0.05 and mean episode length >= 480, and the
   rollout entry point (N = 16,384, 512 steps at hover) must stay finite; each
   kernel must have launched;
6. time each kernel and its plain version at the main-path shapes (CUDA
   events, median of 5 after a warm-up) and print one `{"kernels": [...]}`
   line with launches, error, times and the bound;
7. last line: {"ok": true, "device": {...}}.

It imports neither JAX nor the JAX package. Without a CUDA device, or without
the `raptor_tpu_torch` package beside it, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
N = 16_384
T_ROLLOUT = 512
T_EVAL = 500
STUDENT = os.path.join(ROOT, "raptor_tpu_torch", "data", "student_rateFlagCurMix.npz")

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

    from raptor_tpu_torch.apps import evaluate as evaluate_cli
    from raptor_tpu_torch.checkpoint import from_numpy, h5
    from raptor_tpu_torch.env import EnvConfig, L2F, dynamics, eval_parity_init
    from raptor_tpu_torch.env.randomization import sample_population
    from raptor_tpu_torch.env.types import tree_map
    from raptor_tpu_torch.ops import build
    from raptor_tpu_torch.ops import eval as ops_eval
    from raptor_tpu_torch.ops import rollout as ops_rollout

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

    # 5. the main path, with launch counts from 0
    ops_eval.launches = 0
    ops_rollout.launches = 0
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

    # 6. timing at the main-path shapes
    g_frames = torch.Generator(device=dev).manual_seed(0)
    m_frames = tree_map(lambda x: x.repeat_interleave(8, 0), sample_population(g_frames, N // 8))
    m_env = L2F(EnvConfig(init=eval_parity_init()))
    m_es, _ = m_env.reset(m_frames, torch.Generator(device=dev).manual_seed(1))
    m_ps, m_ss = m_frames.to_soa(), m_es.dynamics.to_soa()

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
    )
    for name, source, replaces, kernel, plain, flops_step, n_bytes, err in specs:
        # threads leave the loop when their env dies: count the env-steps run
        env_steps = float(kernel()[1][1].sum())
        ms = time_ms(torch, kernel)
        plain_ms = time_ms(torch, plain)
        t_ops = flops_step * env_steps / peak_flops * 1e3
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

    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
