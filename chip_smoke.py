#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (`raptor_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA Hopper card
(sm_90a) and the CUDA toolkit. Phases, in order; any failure ends the run
with a non-zero exit code and no result line:

1. the card's name and power limit (nvidia-smi);
2. build the CUDA kernels from `raptor_tpu_torch/csrc/` (nvcc, one process per
   unit, all in parallel: the eval and collect sources once a hidden width)
   and print each unit's seconds, ptxas' register and spill counts of every
   kernel and the lanes a team of the rollout, eval and collect kernels
   (`COLLECT_TEAM`);
3. rollout kernel vs its plain PyTorch version on N = 16,384 random airframes:
   20 steps with termination off (atol 2e-4, rtol 1e-3 on every state field),
   then 512 steps at hover with default bounds (finite, |q| = 1 +- 1e-5);
4. eval kernel vs its plain version on N = 16,384, default init, 25 steps with
   the committed student, then with a student of hidden width 32 (random
   weights from a seed): alive and length agree on >= 99.9% of envs; on
   those, return within atol 5e-3 / rtol 1e-3 and position within atol 1e-3;
5. the serving main path with every launch count set to 0: the evaluate CLI
   with `--fused` (N = 2,048 x 8 = 16,384 envs, 500 steps, eval-parity init)
   must give share_terminated <= 0.05 and mean episode length >= 480, and the
   rollout entry point (N = 16,384, 512 steps at hover) must stay finite; each
   kernel must have launched. Then, counted from 0 again, the evaluate CLI
   with `--fused` flies the width-32 student (2,048 envs) and must launch the
   eval kernel and give five finite statistics;
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
   atol 1e-5. Checks (a) and (c) with the width-32 student on the 944 envs;
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
9. FMA peak kernel vs its plain version at depth 64 x 32 steps on random
   inputs in [0.5, 1.5], at the size that fills the card and at a ragged one
   (100,003 elements): rtol 1e-5 (both round once a step; see
   `ops/fma_peak.py`); on inputs of 1.0 every output must equal element 0 bit
   for bit. Then the roofline main path with launch counts from 0:
   `apps.roofline.main` must launch the kernel at two depths, report a peak,
   a value within 2 % of the closed form, and at most 105 % of the data
   sheet's FP32 rate;
10. the bench main path: `python -m raptor_tpu_torch.bench` in a subprocess at
   full widths (its five sub-benches each in their own process), the
   distillation sub-bench cut in depth to 8 gradient steps a round instead of
   183: five finite values, and the launch counts each sub-bench read from 0
   after its warm-up: the rollout sub-bench must have launched the rollout
   kernel >= 50 times, the eval sub-bench the eval kernel >= 25 times, the
   three eager sub-benches no kernel; then `apps.roofline.main --bench` on
   that line prints the utilizations against the measured peak;
11. the teacher-farm main path: `apps.pre_training.main` at the production
   wave's flags (128 teachers x 32 envs, replay capacity 1,536, row sampling,
   10 super-steps a call) cut in depth only (3 calls, one evaluation, one
   export): finite metrics, a manifest of 128 teachers that `load_teachers`
   reads; prints seconds per super-step, env-steps/s, peak device memory and
   the launch counts read from 0 right after it (the farm is eager PyTorch
   and must launch no kernel). Then `apps.post_training.main` distills that manifest for one tiny round;
12. time each kernel and its plain version at the main-path shapes (CUDA
   events, median of 5 after a warm-up; 3 for the collect's plain version),
   the collect kernel also at a distillation round's 944 envs, and print one
   `{"kernels": [...]}` line with the launches of phases 5, 7
   and 9 (`launches`), those of the bench's processes in phase 10
   (`bench_launches`), the lanes that fly one env (`threads_per_env`), error,
   times and the bound (printed after phases 13 to 17, which must pass first);
13. export, with every launch count from 0 until the end of phase 17 (the
   deployment path and the teacher gate run on the host or as eager PyTorch
   and must launch no kernel): `python -m raptor_tpu_torch.apps.export_policy`
   on the committed `data/student_rateFlagCurPure.npz` in both formats (the
   rltools self-test below 1e-5), and on the flagship `.npz`, whose golden
   output was written on another device, it must exit 2;
14. native executor and firmware, built with g++/gcc from `native/` by
   `inference.native`: the executor's self-test at most 1e-4, the firmware's
   boot status OK. Then the card's `Executor` against the native executor:
   2,000 calls at the 400 Hz schedule (2,500 us steps) fed from the golden
   inputs, actions within 1e-5 and every status 0; prints each one's median
   and p99 latency a call;
15. software in the loop: the firmware flies a crazyflie for 500 steps of the
   port's `L2F` on the card (initial attitudes up to 0.5 rad, 4 firmware calls
   a step): no failsafe, no termination, |position| < 5 m at the end;
16. the teacher gate at the JAX report's shape: `apps.eval_teachers` on
   `artifacts/teachers_seed900_30M.npz` (128 teachers x 4 envs x 500 steps,
   `--max-angle 0.2`) on the card, then `apps.filter_teachers --max-term 0.5`
   on its report; prints the seconds of the evaluation, the teachers kept and
   how often the card's gate agrees with the committed
   `artifacts/eval_teachers_hover02b.json`. It fails under 85 % agreement,
   with a count kept more than 6 off the report's 115, or with more than 4
   teachers decided otherwise than the report put them at a share of 0 or 1
   (`gate_agreement`). Then
   `filter_teachers` on the committed report must reproduce
   `artifacts/teachers_seed900_hovergate.npz` array for array;
17. the l2f shim's README loop (`vector8`, `Raptor` on the card, 500 steps:
   finite observations and positions, dts 0.01), then `apps.flight_eval
   record --hover-start` with the same student, `analyze` (no crash) and
   `replay` (final divergence under 1 cm);
18. last line: {"ok": true, "device": {...}}.

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

# the production teacher wave (docs/MIGRATION.md), cut in depth only
WAVE = ["--population", "128", "--steps-per-call", "10", "--replay-capacity", "1536",
        "--sample-rows"]
WAVE_DEPTH = ["--super-steps", "3", "--eval-every", "3", "--log-every", "1",
              "--checkpoint-every", "0"]
BENCH_GRAD_STEPS = 8  # the distillation sub-bench's gradient steps a round (full: 183)

# the deployment path's student: its golden output replays on the CPU within
# the exporter's 1e-3 (the flagship's, written on another device, does not)
DEPLOY_STUDENT = os.path.join(ROOT, "raptor_tpu_torch", "data", "student_rateFlagCurPure.npz")
# the teacher gate of the flagship recipe, at the committed report's shape
GATE_PACK = "artifacts/teachers_seed900_30M.npz"
GATE_REPORT = "artifacts/eval_teachers_hover02b.json"
GATE_GATED = "artifacts/teachers_seed900_hovergate.npz"
# The card draws other initial states than the committed report (written on
# another device), so single decisions may differ; the gate as a whole may not.
GATE_AGREEMENT = 0.85  # share of teachers both gates decide alike
GATE_KEPT_SPREAD = 6  # teachers kept, off the committed report's count
GATE_CLEAR_MISSES = 4  # decisions differing on teachers the report put at share 0 or 1

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


def percentiles_us(seconds):
    """(median, p99) of per-call seconds, in microseconds."""
    ordered = sorted(seconds)
    return (statistics.median(ordered) * 1e6,
            ordered[min(len(ordered) - 1, int(0.99 * len(ordered)))] * 1e6)


def gate_agreement(card_term, committed_term):
    """Hold one pack's gate on the card to the committed report's: per-teacher
    termination shares in, `(kept, agreement, clear_misses, faults)` out. A
    teacher is kept at a share under 0.5. A clear miss is a teacher decided
    otherwise than the report, which put it at a share of 0 or 1: an eval
    that never (or always) terminates misses every such teacher on one side.
    `faults` lists what breaks the bounds above; empty when the gate holds."""
    import numpy as np

    card, ref = np.asarray(card_term), np.asarray(committed_term)
    miss = (card < 0.5) != (ref < 0.5)
    kept, ref_kept = int((card < 0.5).sum()), int((ref < 0.5).sum())
    agreement = float(1.0 - miss.mean())
    clear = int((miss & ((ref == 0.0) | (ref == 1.0))).sum())
    faults = []
    if agreement < GATE_AGREEMENT:
        faults.append(f"agreement {agreement:.3f} under {GATE_AGREEMENT}")
    if abs(kept - ref_kept) > GATE_KEPT_SPREAD:
        faults.append(f"kept {kept}, the report {ref_kept} +- {GATE_KEPT_SPREAD}")
    if clear > GATE_CLEAR_MISSES:
        faults.append(f"{clear} clear misses, more than {GATE_CLEAR_MISSES}")
    return kept, agreement, clear, faults


def sitl_flight(torch, firmware, dev, steps: int = 500) -> float:
    """Phase 15: the booted `firmware` flies a crazyflie for `steps` steps of
    the port's `L2F` on `dev` from attitudes up to 0.5 rad, 4 firmware calls a
    10 ms step, its throttle mapped back to the [-1, 1] motor frame. Raises on
    a failsafe or a termination; returns the final distance from the origin
    in metres."""
    from raptor_tpu_torch.env import EnvConfig, InitConfig, L2F, presets
    from raptor_tpu_torch.inference import Firmware

    env = L2F(EnvConfig(init=InitConfig(max_angle=0.5)))
    frame = presets.crazyflie(dev)
    gen = torch.Generator(device=dev).manual_seed(4)
    es, _ = env.reset(frame, gen)
    t_us = 0
    for t in range(steps):
        est = [getattr(es.dynamics, k)[0].cpu().numpy() for k in (
            "position", "orientation", "linear_velocity", "angular_velocity")]
        for j in range(4):
            throttle, status = firmware.step(t_us, *est)
            if status != Firmware.OK:
                raise AssertionError(f"SITL: failsafe (status {status}) at step {t}.{j}")
            t_us += 2500
        action = torch.as_tensor(2.0 * throttle - 1.0, device=dev)[None]
        es, _, _, _, info = env.step(frame, es, action, gen)
        if bool(info["terminated"][0]):
            raise AssertionError(f"SITL: crashed at step {t}")
    return float(torch.linalg.norm(es.dynamics.position[0]))


def readme_loop(dev, steps: int):
    """The reference README's loop through the l2f shim's `vector8` on `dev`,
    the deployment student flying all 8 envs. Raises on a non-finite
    observation or position or a step other than 0.01 s; returns the vector
    environment and its final state."""
    import numpy as np

    from raptor_tpu_torch.env import l2f_compat as l2f
    from raptor_tpu_torch.policy.raptor import Raptor

    device = l2f.Device(str(dev))
    vector = l2f.vector8
    rng, venv = vector.VectorRng(), vector.VectorEnvironment()
    vparams, state, next_state = (vector.VectorParameters(), vector.VectorState(),
                                  vector.VectorState())
    l2f.initialize_rng(device, rng, seed=0)
    l2f.initialize_environment(device, venv)
    l2f.sample_initial_parameters(device, venv, vparams, rng)
    l2f.sample_initial_state(device, venv, vparams, state, rng)
    policy = Raptor(DEPLOY_STUDENT, batch_size=8, device=dev)
    policy.reset()
    obs = np.zeros((8, venv.OBSERVATION_DIM), np.float32)
    for t in range(steps):
        l2f.observe(device, venv, vparams, state, obs, rng)
        dts = l2f.step(device, venv, vparams, state, policy.evaluate_step(obs[:, :22]),
                       next_state, rng)
        state.assign(next_state)
        if not (np.all(np.isfinite(obs)) and dts.shape == (8,) and np.all(dts == np.float32(0.01))
                and np.all(np.isfinite(state.states[0].position))):
            raise AssertionError(f"l2f shim: a non-finite observation or a wrong dt at step {t}")
    return venv, state


def deployment_and_gate(torch, dev) -> None:
    """Phases 13 to 17 (see the module docstring) on `dev`, the card (a CPU
    device rehearses them at the same shapes); raises on any failure."""
    import numpy as np

    from raptor_tpu_torch.apps import eval_teachers as eval_teachers_cli
    from raptor_tpu_torch.apps import filter_teachers as filter_teachers_cli
    from raptor_tpu_torch.apps import flight_eval as flight_eval_cli
    from raptor_tpu_torch.checkpoint import h5, rltools_export
    from raptor_tpu_torch.inference import (
        Executor, Firmware, NativeExecutor, build_executor, build_firmware,
    )
    from raptor_tpu_torch.ops import collect as ops_collect
    from raptor_tpu_torch.ops import eval as ops_eval
    from raptor_tpu_torch.ops import fma_peak as ops_fma_peak
    from raptor_tpu_torch.ops import rollout as ops_rollout
    from raptor_tpu_torch.utils import flightlog

    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    wrappers = (ops_rollout, ops_eval, ops_collect, ops_fma_peak)
    for w in wrappers:
        w.launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        # 13. export, as a user runs it
        t0 = time.perf_counter()
        headers = {}
        for fmt in ("raptor", "rltools"):
            headers[fmt] = os.path.join(tmp, f"policy_{fmt}.h")
            out = subprocess.run(
                [sys.executable, "-m", "raptor_tpu_torch.apps.export_policy", DEPLOY_STUDENT,
                 headers[fmt], "--format", fmt], cwd=ROOT, stdout=subprocess.PIPE, text=True,
                timeout=300, check=True).stdout.strip()
            print(f"export: {out}")
        drift = float(out.split("drift: ")[1])
        self_test = float(out.split("max-err: ")[1].split()[0])
        if not (self_test < 1e-5 and drift < 1e-3):
            raise AssertionError(f"export: rltools self-test {self_test}, drift {drift}")
        refused = subprocess.run(
            [sys.executable, "-m", "raptor_tpu_torch.apps.export_policy", STUDENT,
             os.path.join(tmp, "flagship.h")], cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, timeout=300)
        print(f"export: the flagship exits {refused.returncode}: {refused.stderr.strip()}")
        if refused.returncode != 2 or os.path.exists(os.path.join(tmp, "flagship.h")):
            raise AssertionError("export: the flagship's drifted golden output was not refused")
        print(f"export: {time.perf_counter() - t0:.1f} s, drift {drift:.2e}, rltools self-test "
              f"{self_test:.2e}")

        # 14. native executor and firmware, then the card's Executor against
        # the native one at the 400 Hz schedule
        t0 = time.perf_counter()
        native = NativeExecutor(build_executor(headers["raptor"]))
        firmware_so = build_firmware(headers["raptor"])
        firmware = Firmware(firmware_so)
        native_err = native.self_test()
        print(f"native: built in {time.perf_counter() - t0:.1f} s, self-test max err "
              f"{native_err:.2e}, firmware boot status {firmware.boot_status}")
        if native_err > 1e-4 or firmware.boot_status != Firmware.OK:
            raise AssertionError(f"native: self-test {native_err}, boot {firmware.boot_status}")
        params = h5.load_actor(DEPLOY_STUDENT)
        _, golden_in, _ = rltools_export.import_rltools_header(headers["rltools"])
        executor = Executor(params, device=dev)
        executor.control(0, golden_in[0, 0])  # warm-up: the first launches initialise the card
        executor.reset()
        native.reset()
        card_s, host_s, max_err = [], [], 0.0
        for i in range(2000):
            t_us, obs = 2500 * i, golden_in[i % 500, (i // 500) % 2]
            t0 = time.perf_counter()
            a_card, s_card = executor.control(t_us, obs)
            t1 = time.perf_counter()
            a_host, s_host = native.control(t_us, obs)
            t2 = time.perf_counter()
            card_s.append(t1 - t0)
            host_s.append(t2 - t1)
            max_err = max(max_err, float(np.max(np.abs(a_card - a_host))))
            if s_card or s_host:
                raise AssertionError(f"executors: call {i} status {s_card} / {s_host}")
        if max_err > 1e-5:
            raise AssertionError(f"executors: card and native actions differ by {max_err:.2e}")
        (c_med, c_p99), (h_med, h_p99) = percentiles_us(card_s), percentiles_us(host_s)
        print(f"executors: 2000 calls at 400 Hz, actions agree to {max_err:.2e}, every status 0; "
              f"latency a call: Executor on {dev} median {c_med:.1f} us, p99 {c_p99:.1f} us; "
              f"NativeExecutor on the host median {h_med:.2f} us, p99 {h_p99:.2f} us")

        # 15. software in the loop against the card's simulator
        t0 = time.perf_counter()
        sitl = Firmware(firmware_so)  # the same library: boot again, fresh state
        sitl.reset()
        dist = sitl_flight(torch, sitl, dev)
        print(f"SITL: 500 steps, no failsafe, no termination, |position| {dist:.3f} m at the "
              f"end, {time.perf_counter() - t0:.1f} s")
        if not dist < 5.0:
            raise AssertionError(f"SITL: ended {dist} m out")

        # 16. the teacher gate, from the root with the relative pack path
        report_path = os.path.join(tmp, "eval_teachers.json")
        sync()
        t0 = time.perf_counter()
        report = eval_teachers_cli.main([GATE_PACK, "--episodes", "4", "--max-angle", "0.2",
                                         "--out", report_path, "--device", str(dev)])
        sync()
        gate_s = time.perf_counter() - t0
        kept = filter_teachers_cli.main([GATE_PACK, os.path.join(tmp, "gated.npz"), "--eval",
                                         report_path, "--max-term", "0.5"])
        with open(GATE_REPORT) as f:
            committed = json.load(f)[GATE_PACK]["per_teacher_share_terminated"]
        gate_kept, agree, clear, faults = gate_agreement(
            report[GATE_PACK]["per_teacher_share_terminated"], committed)
        print(f"teacher gate: eval_teachers of 128 teachers x 4 envs x 500 steps {gate_s:.2f} s; "
              f"kept {kept} of 128 (the committed report keeps "
              f"{sum(x < 0.5 for x in committed)}); the gate decisions agree on "
              f"{100 * agree:.1f} % of teachers, {clear} differ on a teacher the report put "
              f"at share 0 or 1")
        if faults or kept != gate_kept:
            raise AssertionError(f"teacher gate: {faults}, filter_teachers kept {kept}")
        filter_teachers_cli.main([GATE_PACK, os.path.join(tmp, "gated_committed.npz"), "--eval",
                                  GATE_REPORT, "--max-term", "0.5"])
        with np.load(os.path.join(tmp, "gated_committed.npz")) as got, np.load(GATE_GATED) as want:
            if sorted(got.files) != sorted(want.files) or not all(
                    np.array_equal(got[k], want[k]) for k in want.files):
                raise AssertionError(f"teacher gate: {GATE_GATED} not reproduced")
        print(f"teacher gate: the committed report reproduces {GATE_GATED} array for array")

        # 17. the l2f shim's README loop, then flight evaluation on the card
        t0 = time.perf_counter()
        _, state = readme_loop(dev, 500)
        print(f"l2f shim: vector8 README loop, 500 steps on {state.dynamics.position.device}, "
              f"finite, {time.perf_counter() - t0:.1f} s")
        log_path = os.path.join(tmp, "flight.csv")
        t0 = time.perf_counter()
        flight_eval_cli.main(["record", log_path, "--checkpoint", DEPLOY_STUDENT,
                              "--hover-start", "--device", str(dev)])
        flight = flight_eval_cli.main(["analyze", log_path, "--device", str(dev)])
        replay = flight_eval_cli.main(["replay", log_path, "--device", str(dev)])
        print(f"flight eval: {len(flightlog.read_csv(log_path).t_us)} samples, position RMSE "
              f"{flight['position_rmse_m']:.4f} m, crashed {flight['crashed']}, replay final "
              f"divergence {replay['divergence_final_m']:.2e} m, {time.perf_counter() - t0:.1f} s")
        if flight["crashed"] or not replay["divergence_final_m"] < 1e-2:
            raise AssertionError(f"flight eval: {flight} {replay}")
    launches = {w.__name__.rsplit(".", 1)[1]: w.launches for w in wrappers}
    print(f"deployment and teacher gate launches: {launches}")
    if any(launches.values()):
        raise AssertionError("the deployment path and the gate run no kernel, yet one launched")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false")
    if not os.path.isfile(os.path.join(ROOT, "raptor_tpu_torch", "__init__.py")):
        return fail(f"no raptor_tpu_torch package beside {__file__}")
    sys.path.insert(0, ROOT)
    os.chdir(ROOT)  # the manifests and reports name their packs relative to the root

    from raptor_tpu_torch.apps import bench_collect as bench_collect_cli
    from raptor_tpu_torch.apps import evaluate as evaluate_cli
    from raptor_tpu_torch.apps import post_training as post_training_cli
    from raptor_tpu_torch.apps import pre_training as pre_training_cli
    from raptor_tpu_torch.apps import roofline as roofline_cli
    # the operation counts behind every bound below: one source with the
    # roofline report
    from raptor_tpu_torch.apps.roofline import (
        FLOPS_COLLECT_RESET, FLOPS_COLLECT_STEP, FLOPS_EVAL_STEP, FLOPS_ROLLOUT_STEP,
    )
    from raptor_tpu_torch.checkpoint import from_numpy, h5
    from raptor_tpu_torch.distill import population
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
    from raptor_tpu_torch.ops import fma_peak as ops_fma_peak
    from raptor_tpu_torch.ops import rollout as ops_rollout
    from raptor_tpu_torch.policy import network
    from raptor_tpu_torch.rl import networks, runner, sac

    # 1. the card
    print(roofline_cli.card_name_and_power_limit())
    kind = torch.cuda.get_device_name(0)
    print(f"torch device: {kind}")
    dev = torch.device("cuda", 0)
    sku, (peak_flops, peak_bytes) = peaks_for(kind)

    # 2. build
    t0 = time.perf_counter()
    build.cuda_library()
    print(f"build: {time.perf_counter() - t0:.1f} s")
    for line in build.cuda_build_log().splitlines():
        if line.startswith("unit "):
            print(f"build: {line.strip()}")
        elif "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"ptxas: {line.strip()}")
    threads_per_env = {"rollout": ops_rollout.threads_per_env(),
                       "eval": ops_eval.threads_per_env(),
                       "collect": ops_collect.threads_per_env()}
    print(f"lanes an env: {threads_per_env}; collect kernel: COLLECT_TEAM = "
          f"{threads_per_env['collect']}")
    sass = build.cuda_sass_counts("fma_peak_kernelILi32E")
    if sass is None:
        print("sass: cuobjdump not found beside nvcc, the FFMA count of fma_peak_kernel<32> "
              "was not checked")
    else:
        # 32 steps x 8 chains = 256 FFMA an iteration of the inner loop
        print(f"sass: fma_peak_kernel<32>: {sass[0]} FFMA of {sass[1]} instructions")
        if sass[0] < 256:
            raise AssertionError("fma_peak_kernel<32>: the unrolled FFMA body is not there")

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

    # a student of hidden width 32, biases and h0 drawn too (init_params
    # leaves them at 0)
    wide = network.init_params(torch.Generator(device=dev).manual_seed(32), hidden_dim=32)
    g_wide = torch.Generator(device=dev).manual_seed(33)
    for layer, name in (("dense_0", "biases"), ("gru_1", "biases_input"),
                        ("gru_1", "biases_hidden"), ("gru_1", "initial_hidden_state"),
                        ("dense_2", "biases")):
        t = wide[layer][name]
        t.add_(0.1 * torch.randn(t.shape, device=dev, generator=g_wide))
    wide_weights = ops_eval.flatten_policy(wide)
    k_out, k_stats = ops_eval.eval_soa(wide_weights, ps, ss, 25)
    p_out, p_stats = ops_eval.eval_plain(wide, ps, ss, 25)
    torch.cuda.synchronize()
    agree = (k_stats[0] == p_stats[0]) & (k_stats[1] == p_stats[1])
    n_agree = int(agree.sum())
    if n_agree < 0.999 * N:
        raise AssertionError(f"eval, hidden 32: alive/length agree on only {n_agree}/{N} envs")
    eval_err_32 = max(
        check_close("eval return, hidden 32", k_stats[2][agree], p_stats[2][agree], 5e-3, 1e-3),
        check_close("eval position, hidden 32", k_out[0:3][:, agree], p_out[0:3][:, agree],
                    1e-3, 0.0),
    )
    print(f"eval, hidden 32: kernel vs plain, 25 steps, alive and length agree on "
          f"{n_agree}/{N} envs, max abs err (return, position) {eval_err_32:.3e}")
    eval_err = max(eval_err, eval_err_32)

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
    with tempfile.TemporaryDirectory() as wide_dir:
        wide_ckpt = os.path.join(wide_dir, "student_h32.npz")
        h5.save_actor(wide_ckpt, wide)
        ops_eval.launches = 0
        wide_stats = evaluate_cli.main([
            wide_ckpt, "--fused", "--n-airframes", "256", "--envs-per-airframe", "8",
            "--episode-length", str(T_EVAL), "--eval-parity-init", "--device", "cuda"])
        print(f"main path, hidden 32: eval launches {ops_eval.launches}")
        if ops_eval.launches < 1 or not all(math.isfinite(wide_stats[k]) for k in (
                "return/mean", "return/std", "episode_length/mean", "episode_length/std",
                "share_terminated")):
            raise AssertionError(f"main path, hidden 32: {ops_eval.launches} launches, "
                                 f"{wide_stats}")

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

    def check_collect(pop, policy=policy, weights=weights, with_b=True):
        """Checks (a)-(c) ((a) and (c) without `with_b`) on the airframes
        `pop`; returns the largest observation error of (a) and (c)."""
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

        b_note = "(b) not run"
        if with_b:
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
            b_note = (f"(b) episode length 8, reset masks agree on {same} of entries, "
                      f"{after.shape[0]} fresh rows inside the init box")

        (k_obs, k_reset), (p_obs, p_reset) = collect_both(every, 10, 5, pop_ss)
        if float(k_reset.min()) != 1.0 or float(p_reset.min()) != 1.0:
            raise AssertionError("collect (c): an env did not reset at every step")
        err_c = check_close("collect (c) obs", k_obs, p_obs, 1e-5, 0.0)
        print(f"collect, {n_pop} envs, hidden {ops_eval.hidden_width(weights)}: (a) 20 steps "
              f"without resets, max abs err {err_a:.3e}; {b_note}; (c) every row a fresh "
              f"draw, max abs err {err_c:.3e}")
        return max(err_a, err_c)

    collect_err = max(
        check_collect(pop) for pop in (frames, flatten_envs(env_params), flatten_envs(sub_params)))
    collect_err = max(collect_err, check_collect(
        flatten_envs(sub_params), wide, wide_weights, with_b=False))

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

    # 9. FMA peak kernel vs plain, then the roofline main path
    n_full = ops_fma_peak.default_elements(dev)
    fma_err, fma_depth = 0.0, 64
    for n_el in (n_full, 100_003):
        x = 0.5 + torch.rand(n_el, device=dev, generator=g)
        got = ops_fma_peak.fma_peak(x, fma_depth)
        want = ops_fma_peak.fma_peak_plain(x, fma_depth)
        torch.cuda.synchronize()
        fma_err = max(fma_err, check_close(f"fma_peak, {n_el} elements", got, want, 0.0, 1e-5))
        ones = ops_fma_peak.fma_peak(torch.ones(n_el, device=dev), fma_depth)
        if not bool((ones == ones[0]).all()):
            raise AssertionError(f"fma_peak, {n_el} elements: outputs of equal inputs differ")
        # 9 ulp a step exactly, where exact arithmetic adds 8.84
        if (float(ones[0]) != 1.0 + fma_depth * 32 * 9 * 2.0**-23
                or abs(float(ones[0]) / ops_fma_peak.closed_form(fma_depth * 32) - 1.0) > 1e-4):
            raise AssertionError(f"fma_peak: {float(ones[0])} is not the closed form")
    print(f"fma_peak: kernel vs plain, {fma_depth} x 32 steps on {n_full} and 100003 elements, "
          f"max abs err {fma_err:.3e}; equal inputs give equal outputs")
    x_full = 0.5 + torch.rand(n_full, device=dev, generator=g)
    fma_plain_ms = time_ms(torch, lambda: ops_fma_peak.fma_peak_plain(x_full, fma_depth), reps=3)
    ops_fma_peak.launches = 0
    with tempfile.TemporaryDirectory() as roof_dir:
        roof_out = os.path.join(roof_dir, "roofline.json")
        peak = roofline_cli.main(["--out", roof_out, "--device", "cuda"])["vpu_peak"]
        launches["fma_peak"] = ops_fma_peak.launches
        pk = peak["fma_peak_flops_per_s"]
        if ops_fma_peak.launches < 2 or pk is None:
            raise AssertionError(f"roofline main path: {ops_fma_peak.launches} launches, peak {pk}")
        print(f"roofline main path launches: {ops_fma_peak.launches}; measured FP32 FMA peak "
              f"{pk / 1e12:.2f} TFLOP/s = {100 * pk / peak_flops:.1f} % of the {sku} data "
              f"sheet's {peak_flops / 1e12:.0f} ({peak['card']}); {peak['elements']} elements, "
              f"{peak['chains_per_thread']} chains a thread, block {peak['block']}, grid "
              f"{peak['grid']}; t_lo {peak['t_lo_s']:.4f} s, t_hi {peak['t_hi_s']:.4f} s")
        if pk > 1.05 * peak_flops:
            raise AssertionError("measured FMA peak above 105 % of the data sheet's: the "
                                 "operation count or the clock is wrong")
        if abs(peak["value_hi"] / peak["closed_form_hi"] - 1.0) > 0.02:
            raise AssertionError(f"fma_peak value {peak['value_hi']} vs closed form "
                                 f"{peak['closed_form_hi']}")

        # 10. the bench main path (its own processes), then roofline --bench
        t0 = time.perf_counter()
        bench = subprocess.run(
            [sys.executable, "-m", "raptor_tpu_torch.bench", "--train-grad-steps",
             str(BENCH_GRAD_STEPS)],
            cwd=ROOT, stdout=subprocess.PIPE, text=True, timeout=900)
        bench_line = bench.stdout.strip().splitlines()[-1] if bench.stdout.strip() else ""
        print(f"bench ({BENCH_GRAD_STEPS} gradient steps a distillation round instead of 183, "
              f"wall {time.perf_counter() - t0:.1f} s): {bench_line}")
        if bench.returncode != 0:
            raise AssertionError(f"bench exited {bench.returncode}")
        detail = json.loads(bench_line)["detail"]
        five_rates = [detail[k] for k in (
            "fused_pallas_rollout", "fused_policy_eval", "full_env_step_xla",
            "train_env_steps_per_s", "pretrain_env_steps_per_s")]
        if any(v is None or not math.isfinite(v) or v <= 0 for v in five_rates):
            raise AssertionError(f"bench: a sub-bench gave no value: {detail}")
        # each sub-bench's process counted its wrappers' launches from 0 after
        # its warm-up
        by_sub = detail["launches"]
        bench_launches = {k: sum(sub[k] for sub in by_sub.values())
                          for k in ("rollout", "eval", "collect", "fma_peak")}
        print(f"bench main path launches: {by_sub}")
        eager = ("full_env_step_xla", "train_env_steps_per_s", "pretrain_env_steps_per_s")
        if (by_sub["fused_pallas_rollout"]["rollout"] < 50
                or by_sub["fused_policy_eval"]["eval"] < 25
                or any(n for name in eager for n in by_sub[name].values())):
            raise AssertionError(f"bench main path: launches {by_sub}")
        bench_path = os.path.join(roof_dir, "bench.json")
        with open(bench_path, "w") as f:
            f.write(bench_line + "\n")
        roof = roofline_cli.main(["--bench", bench_path, "--out", roof_out, "--skip-peak"])
        print(f"roofline --bench: fused_rollout_vpu_utilization "
              f"{roof['fused_rollout_vpu_utilization']:.4f}, fused_eval_vpu_utilization "
              f"{roof['fused_eval_vpu_utilization']:.4f}, env_step_xla_vpu_utilization "
              f"{roof['env_step_xla_vpu_utilization']:.6f} of the measured peak")

    # 11. the teacher-farm main path, cut in depth, then distillation from it
    with tempfile.TemporaryDirectory() as exp_dir:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops_eval.launches = ops_rollout.launches = ops_collect.launches = 0
        ops_fma_peak.launches = 0
        t0 = time.perf_counter()
        manifest, wave = pre_training_cli.main(
            [*WAVE, *WAVE_DEPTH, "--experiments-dir", exp_dir, "--device", "cuda"],
            return_summary=True)
        wave_wall = time.perf_counter() - t0
        wave_mem = torch.cuda.max_memory_allocated()
        farm_launches = {"rollout": ops_rollout.launches, "eval": ops_eval.launches,
                         "collect": ops_collect.launches, "fma_peak": ops_fma_peak.launches}
        print(f"teacher-farm main path launches: {farm_launches}")
        if any(farm_launches.values()):
            raise AssertionError("the teacher farm is eager PyTorch, yet a kernel launched")
        wave_actors, wave_frames = post_training_cli.load_teachers(manifest, dev)
        scalars = [v for row in wave["metrics"] + wave["evaluations"]
                   for k, v in row.items() if k != "step"]
        if (networks.n_actors(wave_actors) != 128 or wave_frames.mass.shape[0] != 128
                or len(wave["metrics"]) != 3 or len(wave["evaluations"]) != 1
                or not all(math.isfinite(v) for v in scalars)):
            raise AssertionError(f"teacher-farm main path: {wave}")
        per_call = statistics.median(wave["seconds_per_call"])
        print(f"teacher farm: 128 teachers x 32 envs, {wave['seconds_per_call']} s a call of 10 "
              f"super-steps ({per_call / 10:.4f} s a super-step, "
              f"{128 * wave['env_steps_per_call_per_teacher'] / per_call:.0f} env-steps/s), "
              f"wall {wave_wall:.1f} s, peak device memory {wave_mem / 2**30:.2f} GiB; "
              f"last metrics {wave['metrics'][-1]}, evaluation {wave['evaluations'][-1]}")
        # where a super-step's time goes (outside the counted runs): collect and
        # train timed apart at the wave's shape, and at an eighth of the
        # teachers: equal times mean the host's launch rate is the limit
        for k_pop in (128, 16):
            pop_gen = torch.Generator(device=dev).manual_seed(5)
            pop_cfg = population.PopulationConfig(
                n_teachers=k_pop, envs_per_teacher=32, replay_capacity=1536, sample_rows=True)
            pop_env = L2F(EnvConfig())
            states, pop_params, run_cfg = population.population_init(
                pop_gen, pop_env, population.sample_teacher_airframes(pop_gen, k_pop), pop_cfg)
            states = population.make_population_warmup(pop_env, run_cfg)(states, pop_params)
            phase_s = {}
            for _ in range(2):  # the second pass is the warm one
                for phase, fn in (
                        ("collect", lambda: runner.collect(states, pop_env, pop_params, run_cfg)),
                        ("train", lambda: runner.train(states, run_cfg, sac.SACConfig()))):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    fn()
                    torch.cuda.synchronize()
                    phase_s[phase] = time.perf_counter() - t0
            print(f"super-step of {k_pop} teachers x 32 envs: collect (16 env steps) "
                  f"{phase_s['collect']:.4f} s, train (16 gradient steps) {phase_s['train']:.4f} s")
            del states
        ckpt2, summary2 = post_training_cli.main(
            [manifest, "--rounds", "1", "--envs-per-teacher", "4", "--aggregate-capacity", "512",
             "--grad-steps-per-round", "2", "--batch-size", "16", "--eval-every-rounds", "1",
             "--experiments-dir", exp_dir, "--device", "cuda"], return_summary=True)
        if not all(math.isfinite(x) for x in summary2["loss_history"]):
            raise AssertionError(f"distillation of the fresh teachers: {summary2}")
        print(f"distillation of the fresh teachers: loss {summary2['loss_history']}, self-test "
              f"max err {h5.verify_checkpoint(ckpt2):.2e}")

    # 12. timing at the main-path shapes
    g_frames = torch.Generator(device=dev).manual_seed(0)
    m_frames = tree_map(lambda x: x.repeat_interleave(8, 0), sample_population(g_frames, N // 8))
    m_env = L2F(EnvConfig(init=eval_parity_init()))
    m_es, _ = m_env.reset(m_frames, torch.Generator(device=dev).manual_seed(1))
    m_ps, m_ss = m_frames.to_soa(), m_es.dynamics.to_soa()

    c_ps = flatten_envs(env_params).to_soa()
    c_ss = L2F(EnvConfig()).sample_state(flatten_envs(env_params), gen).to_soa()
    n_c = c_ps.shape[1]
    r_ps = flatten_envs(sub_params).to_soa()  # a distillation round's 944 envs
    r_ss = L2F(EnvConfig()).sample_state(flatten_envs(sub_params), gen).to_soa()
    n_r = r_ps.shape[1]

    rows = []
    specs = (
        ("rollout", "raptor_tpu_torch/csrc/rollout.cu", "raptor_tpu/ops/pallas_rollout.py:200",
         lambda: ops_rollout.rollout_soa(ps, ss, hover, T_ROLLOUT),
         lambda: ops_rollout.rollout_plain(ps, ss, hover, T_ROLLOUT),
         FLOPS_ROLLOUT_STEP, (42 + 17 + 4 + 17 + 2) * 4 * N, rollout_err),
        ("eval", "raptor_tpu_torch/csrc/eval.cu", "raptor_tpu/ops/pallas_eval.py:130",
         lambda: ops_eval.eval_soa(weights, m_ps, m_ss, T_EVAL),
         lambda: ops_eval.eval_plain(policy, m_ps, m_ss, T_EVAL),
         FLOPS_EVAL_STEP, (42 + 17 + 17 + 3) * 4 * N + weights.numel() * 4, eval_err),
        ("collect", "raptor_tpu_torch/csrc/collect.cu", "raptor_tpu/ops/pallas_collect.py:252",
         lambda: ops_collect.collect_soa(weights, c_ps, c_ss, T_COLLECT, 0),
         lambda: ops_collect.collect_plain(policy, c_ps, c_ss, T_COLLECT, 0),
         FLOPS_COLLECT_STEP,
         (42 + 17) * 4 * n_c + weights.numel() * 4 + 23 * 4 * n_c * T_COLLECT, collect_err),
    )
    for name, source, replaces, kernel, plain, flops_step, n_bytes, err in specs:
        if name == "collect":
            # every env runs every step; a reset adds its fresh sample
            env_steps = float(n_c * T_COLLECT)
            n_resets = float(kernel()[1].sum())
            extra_ops = FLOPS_COLLECT_RESET * n_resets
        else:
            # teams leave the loop when their env dies: count the env-steps run
            env_steps = float(kernel()[1][1].sum())
            extra_ops = 0.0
        ms = time_ms(torch, kernel)
        plain_ms = time_ms(torch, plain, reps=3 if name == "collect" else 5)
        t_ops = (flops_step * env_steps + extra_ops) / peak_flops * 1e3
        t_bytes = n_bytes / peak_bytes * 1e3
        rows.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "bench_launches": bench_launches[name],
            "threads_per_env": threads_per_env[name], "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None,
        })
        print(f"{name}: kernel {ms:.3f} ms, plain {plain_ms:.1f} ms, bound {max(t_ops, t_bytes):.4f} ms "
              f"({env_steps:.0f} env-steps, {sku} peaks)")
    # at hover most rollout envs crash within ~50 steps and their teams leave
    # the loop; with termination off every env runs all 512 steps
    off_ms = time_ms(torch, lambda: ops_rollout.rollout_soa(ps, ss, hover, T_ROLLOUT, **off))
    off_bound = FLOPS_ROLLOUT_STEP * N * T_ROLLOUT / peak_flops * 1e3
    print(f"rollout, termination off: kernel {off_ms:.3f} ms, bound {off_bound:.4f} ms "
          f"({N * T_ROLLOUT} env-steps, {sku} peaks)")

    # the collect kernel at a distillation round's shape: fewer envs, fewer warps
    r_resets = float(ops_collect.collect_soa(weights, r_ps, r_ss, T_COLLECT, 0)[1].sum())
    r_ms = time_ms(torch, lambda: ops_collect.collect_soa(weights, r_ps, r_ss, T_COLLECT, 0))
    r_ops = (FLOPS_COLLECT_STEP * n_r * T_COLLECT + FLOPS_COLLECT_RESET * r_resets) / peak_flops
    r_bytes = ((42 + 17) * 4 * n_r + weights.numel() * 4 + 23 * 4 * n_r * T_COLLECT) / peak_bytes
    collect_row = next(row for row in rows if row["name"] == "collect")
    collect_row.update(ms_944=r_ms, bound_ms_944=max(r_ops, r_bytes) * 1e3)
    print(f"collect, {n_r} envs (COLLECT_TEAM = {threads_per_env['collect']}): kernel "
          f"{r_ms:.3f} ms, bound {max(r_ops, r_bytes) * 1e3:.4f} ms ({n_r * T_COLLECT} env-steps, "
          f"{r_resets:.0f} resets, {sku} peaks)")

    # the wrapper hands out obs [T, N, 22] as a view of the kernel's
    # channel-major buffer; a caller that needs it dense pays this transpose
    c_obs = ops_collect.collect_soa(weights, c_ps, c_ss, T_COLLECT, 0)[0]
    dense_ms = time_ms(torch, lambda: c_obs.contiguous())
    print(f"collect: obs.contiguous() of [{T_COLLECT}, {n_c}, 22] {dense_ms:.3f} ms "
          f"(not on the main path)")

    # the FMA peak kernel's row: times from the roofline main path's run
    for depth, t_s in zip(peak["depths"], (peak["t_lo_s"], peak["t_hi_s"])):
        print(f"fma_peak: depth {depth}: kernel {t_s * 1e3:.3f} ms, bound "
              f"{2.0 * 32 * depth * n_full / peak_flops * 1e3:.3f} ms ({sku} peaks)")
    t_ops = 2.0 * 32 * peak["depths"][0] * n_full / peak_flops * 1e3
    t_bytes = 8.0 * n_full / peak_bytes * 1e3
    rows.append({
        "name": "fma_peak", "route": "cuda", "source": "raptor_tpu_torch/csrc/fma_peak.cu",
        "replaces": "raptor_tpu/apps/roofline.py:105", "launches": launches["fma_peak"],
        "bench_launches": bench_launches["fma_peak"],
        # no env: a thread runs the chains of several elements
        "threads_per_env": 1 / peak["chains_per_thread"],
        "max_abs_err": fma_err, "ms": peak["t_lo_s"] * 1e3, "ms_hi": peak["t_hi_s"] * 1e3,
        "plain_ms": fma_plain_ms, "plain_depth": fma_depth, "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes", "library_ms": None,
    })
    deployment_and_gate(torch, dev)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
