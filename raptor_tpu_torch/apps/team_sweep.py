"""Time the rollout (B1), eval (B2) and collect (B3) kernels at several team
shapes on one GPU:

    python -m raptor_tpu_torch.apps.team_sweep [--sizes 1 2 4 8] [--envs 1 2 4] [--policy-only] [--out sweep.json]

The lanes that fly one env are compile-time constants of `csrc/team_step.cuh`
(`ROLLOUT_TEAM`, `COLLECT_TEAM`, and `EvalTeam<H>::K`), as are the envs a
team of the eval kernel flies (`EvalTeam<H>::E`); the port has no runtime
switch for them. For each size K and each E that divides it (`EvalTeam`
takes no other; the other pairs are left out) this script copies the package
into `build/team_sweep/K<K>E<E>/` beside the package, sets the three lane
counts to K and the eval kernel's envs a team to E at every width in the
copy's header (and builds the copy's eval and collect kernels at hidden
widths 16 and 32 only, to keep the build short; `BUILD_JOBS` copies build
at once), then runs one process a copy, one at a time, that holds the copy's
kernels against their plain versions and times them at `chip_smoke.py`'s
main-path shapes. K = 1 is the team code on one lane: no exchange, the
parameters in registers, the work of one env in one thread.
- rollout: N = 16,384 random airframes, 20 steps with termination off (state
  within atol 2e-4 / rtol 1e-3, alive and length equal); timed at T = 512 with
  termination off and at hover with the default bounds;
- eval: the committed student, N = 2,048 airframes x 8 envs from the
  eval-parity init, 25 steps against the plain version (alive and length equal
  on >= 99.9 % of envs, return within 5e-3 / 1e-3, position within 1e-3);
  timed at T = 500, with the ride-along share of its teams
  (`ops.eval.ride_along_share`); and at each built width, a student from the
  width's seed over the same envs with termination off (every env flies all
  T steps), timed at T = 500;
- collect: the committed student on N = 5,528 random airframes (the envs of
  the 691-teacher union), 20 steps against the plain version at
  `chip_smoke.py` phase 6's tolerances (gentle starts inside wide bounds:
  reset masks equal and all zero, observations within 2e-4; a reset after
  every step: observations within 1e-5); timed at T = 500 from the default
  init at N = 5,528 and at N = 944 (the envs of a distillation round).
`--policy-only` times the eval kernel with its physics taken out of the
copy: the RK4 step is replaced by holding the state (and taking the rpm
setpoints as the rotor state), so every env flies all T steps of the policy's
weight loads, FMAs and gates, and nothing else but observation, reward and
termination. Its eval is not held against the plain version; its rollout is.
Times are CUDA-event medians of 5 runs after a warm-up. Each shape prints one
JSON line (with ptxas' registers and spills of its kernels); the last line
holds them all, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

PACKAGE = Path(__file__).resolve().parents[1]
SWEEP_DIR = PACKAGE.parent / "build" / "team_sweep"
N = 16_384
N_COLLECT, N_ROUND = 5_528, 944  # the 691-teacher union's envs, a distillation round's
T_ROLLOUT, T_EVAL, T_COLLECT = 512, 500, 500
WIDTHS = (16, 32)  # the hidden widths the copies build
BUILD_JOBS = 3  # copies built at once
# the eval loops' RK4 steps (E = 1, E = K) and what holds the state instead
RK4_IN_EVAL = {
    "    team_rk4(tm, lp, s, u, sp, dt, s2, u2);\n#pragma unroll\n    for (int j = 0; j < N; ++j) {\n      ret[j]": (
        "#pragma unroll\n    for (int j = 0; j < N; ++j) {\n"
        "      for (int c = 0; c < COMMON; ++c) s2[j][c] = s[j][c];\n"
        "      for (int k = 0; k < R; ++k) u2[j][k] = sp[j][k];\n    }\n"
        "#pragma unroll\n    for (int j = 0; j < N; ++j) {\n      ret[j]"),
    "      team_rk4(sub, lp[g], s[g], u[g], sp[g], dt, s2[g], u2[g]);\n": (
        "      for (int js = 0; js < NS; ++js) {\n"
        "        for (int c = 0; c < COMMON; ++c) s2[g][js][c] = s[g][js][c];\n"
        "        for (int k = 0; k < R; ++k) u2[g][js][k] = sp[g][js][k];\n      }\n"),
}


def _time_ms(torch, fn, reps: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_key(mangled: str):
    """"rollout_kernel", "eval_kernel<H>" or "collect_kernel<H>" for a
    mangled kernel name, else None. The mangled names carry a hash of the
    source's anonymous namespace, which differs between checkouts."""
    m = re.search(r"(rollout|eval|collect)_kernel(?:ILi(\d+)E)?", mangled)
    if not m:
        return None
    return f"{m.group(1)}_kernel" + (f"<{m.group(2)}>" if m.group(2) else "")


def ptxas_counts(log: str) -> dict:
    """`kernel_key` -> [registers, spill stores + loads] of every rollout, eval
    and collect kernel in nvcc's log."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = kernel_key(m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            out.setdefault(name, [None, 0])[1] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.setdefault(name, [None, 0])[0] = int(m.group(1))
    return out


def worker(policy_only: bool = False) -> dict:
    """Build, check and time this package's rollout, eval and collect kernels
    (the eval left unchecked where its physics was taken out)."""
    import torch

    from raptor_tpu_torch.checkpoint import from_numpy, h5
    from raptor_tpu_torch.env import (
        EnvConfig, InitConfig, L2F, TerminationConfig, dynamics, eval_parity_init,
    )
    from raptor_tpu_torch.env.randomization import sample_population
    from raptor_tpu_torch.env.types import tree_map
    from raptor_tpu_torch.ops import build
    from raptor_tpu_torch.ops import collect as ops_collect
    from raptor_tpu_torch.ops import eval as ops_eval
    from raptor_tpu_torch.ops import rollout as ops_rollout
    from raptor_tpu_torch.policy import network

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    frames = sample_population(g, N)
    es, _ = L2F(EnvConfig()).reset(frames, g)
    ps, ss = frames.to_soa(), es.dynamics.to_soa()
    off = dict(pos_bound=1e9, linvel_bound=1e9, angvel_bound=1e9)
    action = torch.tensor([0.1, -0.05, 0.02, 0.0], device=dev)[:, None].expand(4, N).contiguous()
    out, stats = ops_rollout.rollout_soa(ps, ss, action, 20, **off)
    ref_out, ref_stats = ops_rollout.rollout_plain(ps, ss, action, 20, **off)
    torch.testing.assert_close(stats, ref_stats, atol=0, rtol=0)
    torch.testing.assert_close(out, ref_out, atol=2e-4, rtol=1e-3)
    hover = dynamics.hover_action(frames)[None].expand(4, N).contiguous()

    g_frames = torch.Generator(device=dev).manual_seed(0)
    m_frames = tree_map(lambda x: x.repeat_interleave(8, 0), sample_population(g_frames, N // 8))
    m_es, _ = L2F(EnvConfig(init=eval_parity_init())).reset(
        m_frames, torch.Generator(device=dev).manual_seed(1))
    m_ps, m_ss = m_frames.to_soa(), m_es.dynamics.to_soa()
    policy = from_numpy(h5.load_actor(str(PACKAGE / "data" / "student_rateFlagCurMix.npz")), dev)
    weights = ops_eval.flatten_policy(policy)
    (out, stats), (ref_out, ref_stats) = (
        ops_eval.eval_soa(weights, m_ps, m_ss, 25), ops_eval.eval_plain(policy, m_ps, m_ss, 25))
    if not policy_only:
        agree = (stats[0] == ref_stats[0]) & (stats[1] == ref_stats[1])
        assert int(agree.sum()) >= 0.999 * N, int(agree.sum())
        torch.testing.assert_close(stats[2][agree], ref_stats[2][agree], atol=5e-3, rtol=1e-3)
        torch.testing.assert_close(out[0:3][:, agree], ref_out[0:3][:, agree], atol=1e-3, rtol=0)
    students = {h: (weights if h == 16 else ops_eval.flatten_policy(network.init_params(
        torch.Generator(device=dev).manual_seed(h), hidden_dim=h))) for h in build.HIDDEN_WIDTHS}

    # collect: phase 6's checks (a) and (c), then the main-path shapes
    gentle = EnvConfig(
        init=InitConfig(max_angle=0.2, linear_velocity_std=0.02, angular_velocity_std=0.02),
        termination=TerminationConfig(position_bound=50.0, angular_velocity_bound=1000.0))
    c_frames = sample_population(torch.Generator(device=dev).manual_seed(5), N_COLLECT)
    c_ps = c_frames.to_soa()
    c_gen = torch.Generator(device=dev).manual_seed(6)
    gentle_ss = L2F(gentle).sample_state(c_frames, c_gen).to_soa()
    (obs, reset), (ref_obs, ref_reset) = (
        ops_collect.collect_soa(weights, c_ps, gentle_ss, 20, 3, 0, gentle),
        ops_collect.collect_plain(policy, c_ps, gentle_ss, 20, 3, 0, gentle))
    assert float(ref_reset.sum()) == 0.0
    torch.testing.assert_close(reset, ref_reset, atol=0, rtol=0)
    torch.testing.assert_close(obs, ref_obs, atol=2e-4, rtol=0)
    c_ss = L2F(EnvConfig()).sample_state(c_frames, c_gen).to_soa()
    every = EnvConfig(episode_length=1)
    (obs, reset), (ref_obs, ref_reset) = (
        ops_collect.collect_soa(weights, c_ps, c_ss, 10, 5, 0, every),
        ops_collect.collect_plain(policy, c_ps, c_ss, 10, 5, 0, every))
    assert float(reset.min()) == 1.0 and float(ref_reset.min()) == 1.0
    torch.testing.assert_close(obs, ref_obs, atol=1e-5, rtol=0)
    r_frames = sample_population(torch.Generator(device=dev).manual_seed(7), N_ROUND)
    r_ps = r_frames.to_soa()
    r_ss = L2F(EnvConfig()).sample_state(r_frames, c_gen).to_soa()

    length = ops_eval.eval_soa(weights, m_ps, m_ss, T_EVAL)[1][1]
    return {
        "policy_only": policy_only,
        "rollout_lanes": ops_rollout.threads_per_env(),
        "eval_lanes": ops_eval.lanes_per_team(),
        "eval_envs": ops_eval.envs_per_team(),
        "collect_lanes": ops_collect.threads_per_env(),
        "rollout_off_ms": _time_ms(
            torch, lambda: ops_rollout.rollout_soa(ps, ss, hover, T_ROLLOUT, **off)),
        "rollout_hover_ms": _time_ms(
            torch, lambda: ops_rollout.rollout_soa(ps, ss, hover, T_ROLLOUT)),
        "eval_ms": _time_ms(torch, lambda: ops_eval.eval_soa(weights, m_ps, m_ss, T_EVAL)),
        "eval_env_steps": float(length.sum()),
        "eval_ride_along": ops_eval.ride_along_share(
            length, ops_eval.envs_per_team(), ops_eval.lanes_per_team()),
        "eval_off_ms": {h: _time_ms(torch, lambda: ops_eval.eval_soa(
            w, m_ps, m_ss, T_EVAL, **off)) for h, w in students.items()},
        "collect_ms": _time_ms(
            torch, lambda: ops_collect.collect_soa(weights, c_ps, c_ss, T_COLLECT, 0)),
        "collect_944_ms": _time_ms(
            torch, lambda: ops_collect.collect_soa(weights, r_ps, r_ss, T_COLLECT, 0)),
        "ptxas": ptxas_counts(build.cuda_build_log()),
    }


def _copy(k: int, e: int, policy_only: bool) -> Path:
    """The package copied to build/team_sweep/K<k>E<e>/ with the team shape
    set in its header and the widths in its build; returns the copy's root."""
    header = (PACKAGE / "csrc" / "team_step.cuh").read_text()
    root = SWEEP_DIR / f"K{k}E{e}"
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(PACKAGE, root / PACKAGE.name, ignore=shutil.ignore_patterns("__pycache__"))
    text, n_lanes = re.subn(r"constexpr int (ROLLOUT|COLLECT)_TEAM = \d+;",
                            lambda m: f"constexpr int {m.group(1)}_TEAM = {k};", header)
    text, n_k = re.subn(r"static constexpr int K = [^;]+;", f"static constexpr int K = {k};", text)
    text, n_e = re.subn(r"static constexpr int E = [^;]+;", f"static constexpr int E = {e};", text)
    if (n_lanes, n_k, n_e) != (2, 1, 1):
        raise RuntimeError("found the team constants of team_step.cuh "
                           f"{n_lanes}, {n_k}, {n_e} times, not 2, 1, 1")
    if policy_only:
        for rk4, hold in RK4_IN_EVAL.items():
            if text.count(rk4) != 1:
                raise RuntimeError("an eval loop's RK4 step was not found in team_step.cuh")
            text = text.replace(rk4, hold)
    (root / PACKAGE.name / "csrc" / "team_step.cuh").write_text(text)
    build_py = root / PACKAGE.name / "ops" / "build.py"
    build_py.write_text(re.sub(r"HIDDEN_WIDTHS = \([\d, ]+\)", f"HIDDEN_WIDTHS = {WIDTHS}",
                               build_py.read_text()))
    return root


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--sizes", type=int, nargs="+", default=[1, 2, 4, 8],
                   help="lanes a team (K)")
    p.add_argument("--envs", type=int, nargs="+", default=[1],
                   help="envs a team of the eval kernel (E)")
    p.add_argument("--policy-only", action="store_true",
                   help="take the physics out of the eval kernel in the copies")
    p.add_argument("--out", default=None)
    p.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.worker:
        res = worker(args.policy_only)
        print(json.dumps(res))
        return res

    from raptor_tpu_torch.apps.roofline import card_name_and_power_limit

    # E divides K (EvalTeam)
    shapes = [(k, e) for k in args.sizes for e in args.envs if k % e == 0]
    roots = {shape: _copy(*shape, args.policy_only) for shape in shapes}
    build_py = f"from {PACKAGE.name}.ops import build; build.cuda_library()"
    errors, pending, running = {}, list(shapes), {}
    while pending or running:  # at most BUILD_JOBS builds at once
        while pending and len(running) < BUILD_JOBS:
            shape = pending.pop(0)
            running[shape] = subprocess.Popen(
                [sys.executable, "-c", build_py], cwd=roots[shape],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for shape, proc in list(running.items()):
            if proc.poll() is not None:
                log = proc.communicate()[0]
                if proc.returncode:
                    errors[shape] = log[-2000:]
                del running[shape]
        time.sleep(0.2)
    results = {}
    for k, e in shapes:
        key = f"K{k}E{e}"
        if (k, e) in errors:
            results[key] = {"error": errors[(k, e)]}
        else:
            proc = subprocess.run(
                [sys.executable, "-m", f"{PACKAGE.name}.apps.team_sweep", "--worker",
                 *(["--policy-only"] if args.policy_only else [])],
                cwd=roots[(k, e)], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                timeout=600)
            if proc.returncode:
                results[key] = {"error": proc.stderr[-2000:]}
            else:
                results[key] = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps({"lanes": k, "envs": e, **results[key]}), flush=True)
    report = {"card": card_name_and_power_limit(), "shapes": results}
    if args.out:
        Path(args.out).write_text(json.dumps(report, indent=2) + "\n")
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
