"""Speed-of-light accounting for the hot kernels.

Counterpart of `raptor_tpu/apps/roofline.py`. Two measurements, one report:

1. **Useful work per env-step**: FP32 operations and special-function calls
   counted by hand from `csrc/quad_step.cuh` and `env/quad.py` (`flop_counts`).
   PyTorch has no cost analysis for elementwise work, so where the JAX report
   asks XLA, this one states its counts, under the same keys. The kernels'
   bounds in `chip_smoke.py` use the same constants.

2. **Attainable FP32 FMA peak on this card**: the chained-FMA kernel of
   `ops/fma_peak.py`, timed at two depths with CUDA events; the marginal time
   between them cancels launch and memory cost (`measure_fma_peak`). The quad
   kernels are elementwise FP32 code with no tensor-core work, so this is the
   roofline to hold them to.

Report: utilization = (bench rate x operations per step) / measured peak,
plus the special-function call rate.

    python -m raptor_tpu_torch.apps.roofline [--bench bench.json]
        [--out roofline.json] [--skip-peak] [--sweep] [--device cuda]

`--sweep` adds `fma_peak_sweep` to the report: the same measurement at every
count of FMAs an iteration the kernel is built for, and at several element
counts (`sweep_fma_peak`), which shows whether the probe's defaults sit on the
plateau of this card.

`--skip-peak` reuses the peak of a previous `--out` file (for a machine
without a card). With `--device cpu` the peak "measurement" runs the plain
version at a small depth: it exercises the code path and says nothing about
any device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import torch

from raptor_tpu_torch.device import resolve_device
from raptor_tpu_torch.ops import fma_peak as ops_fma_peak

# ---------------------------------------------------------------------------
# Hand counts. Each add, sub, mul, div, sqrt, compare and select is one
# operation; a fused multiply-add is two. Calls to the special-function unit
# (expf, tanhf, logf, sinf, cosf, sqrtf, rsqrtf) are counted apart, as
# "transcendentals", and are not in the operation counts.
# ---------------------------------------------------------------------------

# csrc/quad_step.cuh: derivative 210, so one RK4 step = 4 x 210 + 3 stage
# updates (34 + 68 + 68) + combination 51 + renormalize 13 + rpm clip 8.
FLOPS_RK4_STEP = 4 * 210 + (34 + 68 + 68) + 51 + 13 + 8
SFU_RK4_STEP = 1  # the renormalization's square root
FLOPS_TERMINATION = 20
# the rollout kernel: RK4 step and termination test
FLOPS_ROLLOUT_STEP = FLOPS_RK4_STEP + FLOPS_TERMINATION
# the eval kernel adds observation 30, Dense 22->16 + ReLU 720, GRU 16 x
# (16 x 12) = 3,072 plus gates 16 x 15 = 240, Dense 16->4 + clip 136,
# setpoints 28, reward 42, accumulators 2; its 48 expf/tanhf per env-step
# (3 x 16 gate activations) run on the special-function unit.
FLOPS_EVAL_STEP = FLOPS_ROLLOUT_STEP + 30 + 720 + 3_072 + 240 + 136 + 28 + 42 + 2
SFU_EVAL_STEP = SFU_RK4_STEP + 48
# collect is eval without reward and accumulators, plus the truncation test
# and step count (3); a reset adds 14 hashed uniforms (13 integer operations
# and 3 float each), 7 Box-Muller pairs (6 each, their log/sqrt/sin/cos counted
# apart), the quaternion and scalings (30) and the hover speed (15).
FLOPS_COLLECT_STEP = FLOPS_EVAL_STEP - 42 - 2 + 3
FLOPS_COLLECT_RESET = 14 * 16 + 7 * 6 + 30 + 15
SFU_COLLECT_RESET = 7 * 4 + 2 + 1

# env/quad.py `dynamics_step` with a generator: six normal draws for the
# disturbance force and torque (Philox4x32-10: 10 rounds x 10 integer
# operations + 4 for the counter give four 32-bit words; a Box-Muller pair is
# 14 operations and 4 special-function calls, so four normals cost 132 and 8),
# their scaling (6), and their entry into the four derivative evaluations
# (12 each).
FLOPS_DISTURBANCE = 198 + 6 + 4 * 12
SFU_DISTURBANCE = 12
# env/quad.py `step`: keyed dynamics, reward and termination penalty (44),
# termination (20), step counter and truncation (4), the fresh state every env
# draws (position 116, attitude 142, velocities 204, hover speed 15; 22
# special-function calls), the reset select over the episode state (25), and
# two observations with their privileged tails (110 and 9 each).
FLOPS_ENV_STEP = (FLOPS_RK4_STEP + FLOPS_DISTURBANCE + 44 + FLOPS_TERMINATION + 4
                  + (116 + 142 + 204 + 15) + 25 + 2 * 110)
SFU_ENV_STEP = SFU_RK4_STEP + SFU_DISTURBANCE + 22 + 2 * 9

# NVIDIA data sheet, H100 SXM, FP32 outside the tensor cores, at 700 W
DATA_SHEET_FP32_FLOPS = 67e12


def flop_counts() -> dict:
    """Operations and special-function calls per env-step, by hand, under the
    JAX report's keys, plus the three kernels' own counts.

    The deterministic dynamics count is the useful work of the rollout kernel
    (constant action, no disturbances). The keyed counts are smaller than the
    JAX package's XLA counts mostly because Philox costs less than threefry."""
    return {
        "dynamics_step_flops_deterministic": float(FLOPS_RK4_STEP),
        "dynamics_step_transcendentals_deterministic": float(SFU_RK4_STEP),
        "dynamics_step_flops": float(FLOPS_RK4_STEP + FLOPS_DISTURBANCE),
        "dynamics_step_transcendentals": float(SFU_RK4_STEP + SFU_DISTURBANCE),
        "env_step_flops": float(FLOPS_ENV_STEP),
        "env_step_transcendentals": float(SFU_ENV_STEP),
        "rollout_kernel_step_flops": float(FLOPS_ROLLOUT_STEP),
        "eval_kernel_step_flops": float(FLOPS_EVAL_STEP),
        "eval_kernel_step_transcendentals": float(SFU_EVAL_STEP),
        "collect_kernel_step_flops": float(FLOPS_COLLECT_STEP),
        "collect_kernel_reset_flops": float(FLOPS_COLLECT_RESET),
    }


def card_name_and_power_limit() -> str:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`, first
    line; "nvidia-smi failed" where it cannot be read."""
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, check=False,
        )
    except OSError:
        return "nvidia-smi failed"
    lines = smi.stdout.strip().splitlines()
    return lines[0] if smi.returncode == 0 and lines else "nvidia-smi failed"


def _time_launches(x, depth, nfma, reps, device):
    """Seconds of `reps` launches at `depth`, each timed alone, after a
    warm-up launch; also the last output."""
    times = []
    y = ops_fma_peak.fma_peak(x, depth, nfma)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            y = ops_fma_peak.fma_peak(x, depth, nfma)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) * 1e-3)
    else:
        for _ in range(reps):
            t0 = time.perf_counter()
            y = ops_fma_peak.fma_peak(x, depth, nfma)
            times.append(time.perf_counter() - t0)
    return times, y


def marginal_peak(n_elements: int, nfma: int, depths, t_lo: float, t_hi: float):
    """FLOP/s from the marginal time between two depths; None when the deeper
    run was not slower (the signal drowned in noise)."""
    dflops = 2.0 * nfma * n_elements * (depths[1] - depths[0])
    dt = t_hi - t_lo
    return dflops / dt if dt > 0 else None


def measure_fma_peak(
    n_elements: int | None = None,
    nfma: int = 32,
    reps: int = 5,
    depths=None,
    device="cuda",
) -> dict:
    """Attainable FP32 FMA throughput: `nfma` chained fmaf per loop iteration
    on every element of a device array, timed with CUDA events at two loop
    depths (median of `reps` launches each, after a warm-up); the peak is the
    extra operations over the extra time.

    `n_elements` defaults to the size that fills the card (`ops.fma_peak.
    default_elements`: SMs x resident threads x chains a thread). Every input
    element is 1.0, so every output element must equal element 0 bit for bit
    (raises otherwise); `value_hi` and `closed_form_hi` let the caller hold the
    result to exact arithmetic. On the CPU the plain version runs, at depths
    2 and 6 and 1,024 elements unless told otherwise."""
    device = resolve_device(device)
    on_card = device.type == "cuda"
    if depths is None:
        depths = (1 << 16, 3 << 16) if on_card else (2, 6)
    lo, hi = depths
    if n_elements is None:
        n_elements = ops_fma_peak.default_elements(device) if on_card else 1024
    x = torch.ones(n_elements, dtype=torch.float32, device=device)
    lo_times, _ = _time_launches(x, lo, nfma, reps, device)
    hi_times, y = _time_launches(x, hi, nfma, reps, device)
    if not bool((y == y[0]).all()):
        raise RuntimeError("FMA peak probe: outputs differ between elements")
    t_lo, t_hi = statistics.median(lo_times), statistics.median(hi_times)
    peak = marginal_peak(n_elements, nfma, depths, t_lo, t_hi)
    geometry = ops_fma_peak.last_geometry if on_card else {
        "elements": n_elements, "chains_per_thread": None, "block": None, "grid": None}
    return {
        "fma_peak_flops_per_s": peak,
        # the JAX report's name for the same number, so its readers read this one
        "vpu_fma_peak_flops_per_s": peak,
        "tile": [n_elements],
        **geometry,
        "fma_per_iteration": nfma,
        "depths": [lo, hi],
        "reps": reps,
        "t_lo_s": t_lo,
        "t_hi_s": t_hi,
        "value_hi": float(y[0]),
        "closed_form_hi": ops_fma_peak.closed_form(hi * nfma),
        "share_of_data_sheet_fp32": (
            peak / DATA_SHEET_FP32_FLOPS if on_card and peak is not None else None),
        "device": str(device),
        "card": card_name_and_power_limit() if on_card else None,
    }


SWEEP_KEYS = ("fma_peak_flops_per_s", "elements", "fma_per_iteration", "grid", "t_lo_s",
              "t_hi_s")


def sweep_fma_peak(device="cuda", reps: int = 3, depths=None) -> dict:
    """`measure_fma_peak` over the probe's two parameters, one at a time:
    `by_fma_per_iteration` at every count the kernel is built for and the
    default element count, `by_elements` at 32 FMAs an iteration and 1/8, 1/2,
    1, 2 and a ragged 4.01 times the default element count. Depths 8,192 and
    24,576 on a card (a launch is an eighth of the main measurement's); on the
    CPU the plain version at depths 2 and 6 on 256 to 1,026 elements."""
    device = resolve_device(device)
    on_card = device.type == "cuda"
    if depths is None:
        depths = (1 << 13, 3 << 13) if on_card else (2, 6)
    full = ops_fma_peak.default_elements(device) if on_card else 256
    sizes = [full // 8, full // 2, full, 2 * full, int(4.01 * full) | 1]

    def row(n_elements, nfma):
        m = measure_fma_peak(n_elements, nfma, reps, depths, device)
        return {k: m[k] for k in SWEEP_KEYS}

    return {
        "depths": list(depths),
        "reps": reps,
        "by_fma_per_iteration": [row(full, nfma) for nfma in ops_fma_peak.NFMA_BUILT],
        "by_elements": [row(n, 32) for n in sizes],
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--bench", default=None,
                    help="file whose last line is the JSON line of raptor_tpu_torch.bench")
    ap.add_argument("--out", default=None)
    ap.add_argument("--skip-peak", action="store_true")
    ap.add_argument("--sweep", action="store_true",
                    help="also measure the peak over FMAs an iteration and element counts")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    report = {"backend": "cpu" if args.skip_peak else resolve_device(args.device).type}
    report.update(flop_counts())

    prior = {}
    if args.out:
        try:
            with open(args.out) as f:
                prior = json.load(f)
        except (OSError, ValueError):
            prior = {}
    if args.skip_peak:
        peak = prior.get("vpu_peak") or {}
    else:
        peak = measure_fma_peak(device=args.device)
    # under the JAX report's key, so both reports read the same
    report["vpu_peak"] = peak
    if args.sweep:
        report["fma_peak_sweep"] = sweep_fma_peak(device=args.device)

    rates = {}
    if args.bench:
        with open(args.bench) as f:
            b = json.loads(f.readlines()[-1])
        d = b.get("detail", {})
        rates = {
            "fused_pallas_rollout": d.get("fused_pallas_rollout"),
            "fused_policy_eval": d.get("fused_policy_eval"),
            "full_env_step_xla": d.get("full_env_step_xla"),
        }
    report["rates_env_steps_per_s"] = rates

    pk = (peak or {}).get("fma_peak_flops_per_s")
    if pk and rates.get("fused_pallas_rollout"):
        # deterministic count: the kernel draws no disturbances
        useful = rates["fused_pallas_rollout"] * report["dynamics_step_flops_deterministic"]
        report["fused_rollout_useful_flops_per_s"] = useful
        report["fused_rollout_vpu_utilization"] = useful / pk
        if report["fused_rollout_vpu_utilization"] > 1.0:
            report["peak_warning"] = (
                "utilization > 1: the measured peak is an underestimate "
                "(noise between the two depths, or clocks that moved): re-measure before citing"
            )
        report["fused_rollout_transcendentals_per_s"] = (
            rates["fused_pallas_rollout"] * report["dynamics_step_transcendentals_deterministic"]
        )
    if pk and rates.get("fused_policy_eval"):
        useful = rates["fused_policy_eval"] * report["eval_kernel_step_flops"]
        report["fused_eval_useful_flops_per_s"] = useful
        report["fused_eval_vpu_utilization"] = useful / pk
    if pk and rates.get("full_env_step_xla"):
        useful = rates["full_env_step_xla"] * report["env_step_flops"]
        report["env_step_xla_useful_flops_per_s"] = useful
        report["env_step_xla_vpu_utilization"] = useful / pk

    print(json.dumps(report, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
    return report


if __name__ == "__main__":
    main()
