"""CLI: compare a training run's tfevents against the shipped reference
post-training log.

Counterpart of `raptor_tpu/apps/compare_baseline.py`: the same report, and
the same markdown artifact except that it names the reference tarball by
$RAPTOR_REFERENCE_DIR.

    python -m raptor_tpu_torch.apps.compare_baseline experiments/<run>/events.out.tfevents.*

Prints aligned eval-return curves and the reference headline numbers so
learning-curve parity can be tracked run over run. The reference log lies
beside the shipped checkpoint (`policy.raptor.shipped_checkpoint_path`, read
from the reference checkout named by $RAPTOR_REFERENCE_DIR); without it the
CLI raises FileNotFoundError.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

import numpy as np

from raptor_tpu_torch.policy.raptor import shipped_checkpoint_path
from raptor_tpu_torch.utils import tfevents


def reference_log_path() -> str:
    """The shipped reference post-training log, `logs.tfevents` beside the
    shipped checkpoint; raises FileNotFoundError where either is absent."""
    path = os.path.join(os.path.dirname(shipped_checkpoint_path()), "logs.tfevents")
    if not os.path.exists(path):
        raise FileNotFoundError(f"{path}: no reference training log beside the shipped checkpoint")
    return path


def summarize(scalars: dict, label: str) -> dict:
    out = {"label": label}
    ret = scalars.get("evaluation/return/mean", [])
    if ret:
        out["final_return"] = ret[-1][1]
        out["final_step"] = ret[-1][0]
        out["n_evals"] = len(ret)
        out["curve"] = [
            (s, round(v, 1)) for s, v in ret[:: max(len(ret) // 8, 1)]
        ]
    if "evaluation/episode_length/mean" in scalars:
        out["final_episode_length"] = scalars["evaluation/episode_length/mean"][-1][1]
    if "evaluation/share_terminated" in scalars:
        out["final_share_terminated"] = scalars["evaluation/share_terminated"][-1][1]
    if "loss" in scalars:
        if "gradient_steps" in scalars:
            # post_training decimates the loss series but logs the true
            # counter as its own tag; the reference writes one loss event
            # per gradient step, so its event count IS the counter
            out["n_gradient_steps"] = int(scalars["gradient_steps"][-1][1])
        else:
            out["n_gradient_steps"] = len(scalars["loss"])
        out["final_loss"] = scalars["loss"][-1][1]
    if "crazyflie/return/mean" in scalars:
        out["crazyflie_final_return"] = scalars["crazyflie/return/mean"][-1][1]
    return out


def matched_curves(ours: dict, ref: dict, tags=None) -> dict:
    """Align the two runs on the env-steps axis: for each of our eval points,
    linearly interpolate the reference curve at the same env-step count."""
    tags = tags or [
        "evaluation/return/mean",
        "evaluation/episode_length/mean",
        "evaluation/share_terminated",
        "crazyflie/return/mean",
        "crazyflie/episode_length/mean",
        "crazyflie/share_terminated",
    ]
    out = {}
    for tag in tags:
        o, r = ours.get(tag), ref.get(tag)
        if not o or not r:
            continue
        o_steps = np.asarray([s for s, _ in o], dtype=np.float64)
        o_vals = np.asarray([v for _, v in o])
        r_steps = np.asarray([s for s, _ in r], dtype=np.float64)
        r_vals = np.asarray([v for _, v in r])
        # only the overlap is a matched comparison: np.interp would clamp
        # (silently extrapolate) beyond the reference curve's last step
        in_range = o_steps <= r_steps[-1]
        if not np.any(in_range):
            continue
        o_steps, o_vals = o_steps[in_range], o_vals[in_range]
        r_interp = np.interp(o_steps, r_steps, r_vals)
        stride = max(1, len(o_steps) // 16)
        idx = list(range(0, len(o_steps), stride))
        if (len(o_steps) - 1) % stride:
            idx.append(len(o_steps) - 1)
        out[tag] = [
            {
                "env_steps": int(o_steps[i]),
                "ours": round(float(o_vals[i]), 2),
                "reference": round(float(r_interp[i]), 2),
            }
            for i in idx
        ]
    return out


def write_report(path: str, report: dict) -> None:
    """Markdown artifact: final-stat table + matched-step curve tables."""
    lines = [
        "# Run vs reference post-training (matched env-steps)",
        "",
        f"Ours: `{report['ours']['label']}`",
        f"Reference: {report['reference']['label']} "
        "(tfevents inside $RAPTOR_REFERENCE_DIR/data/raptor-policy-checkpoint.tar.gz)",
        "",
        "## Final stats",
        "",
        "| metric | ours | reference |",
        "|---|---|---|",
    ]
    for k in ("final_return", "final_episode_length", "final_share_terminated",
              "crazyflie_final_return", "n_gradient_steps", "final_loss",
              "final_step"):
        a, b = report["ours"].get(k), report["reference"].get(k)
        if a is not None or b is not None:
            fmt = lambda v: "—" if v is None else (  # noqa: E731
                f"{v:.3f}" if isinstance(v, float) else str(v))
            lines.append(f"| {k} | {fmt(a)} | {fmt(b)} |")
    for tag, rows in report.get("matched_curves", {}).items():
        lines += ["", f"## {tag} (reference interpolated at our env-steps)",
                  "", "| env-steps | ours | reference |", "|---|---|---|"]
        lines += [f"| {r['env_steps']:,} | {r['ours']} | {r['reference']} |"
                  for r in rows]
    lines += ["", "Rows beyond the reference log's final env-step are omitted "
              "(no silent extrapolation); final stats above compare each "
              "run's own end point."]
    lines += ["", "Eval-parity protocol: InitConfig(max_angle=1.0) — measured "
              "to reproduce the reference policy's own logged eval envelope "
              "(apps/eval_parity.py; docs/EVAL_PARITY.md).", ""]
    with open(path, "w") as f:
        f.write("\n".join(lines))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("run_events", nargs="?",
                   help="tfevents file (or glob) of the run to compare; "
                        "default: newest under experiments/")
    p.add_argument("--out", help="write a markdown report artifact here")
    args = p.parse_args(argv)

    if args.run_events:
        candidates = sorted(glob.glob(args.run_events))
    else:
        candidates = sorted(
            glob.glob("experiments/**/events.out.tfevents.*", recursive=True),
            key=os.path.getmtime,
        )
    if not candidates:
        p.error("no run tfevents found")
    run_path = candidates[-1]

    our_scalars = tfevents.read_scalars(run_path)
    ref_scalars = tfevents.read_scalars(reference_log_path())
    ours = summarize(our_scalars, run_path)
    ref = summarize(ref_scalars, "reference post-training (2025-04-19_16-16-17)")
    report = {"ours": ours, "reference": ref}
    if "final_return" in ours and "final_return" in ref:
        report["return_ratio_vs_reference"] = round(
            ours["final_return"] / ref["final_return"], 3
        )
    report["matched_curves"] = matched_curves(our_scalars, ref_scalars)
    print(json.dumps(report, indent=2))
    if args.out:
        write_report(args.out, report)
        print(f"report -> {args.out}", file=sys.stderr)
    return report


if __name__ == "__main__":
    main()
