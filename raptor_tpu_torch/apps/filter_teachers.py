"""Curate a teacher pack by measured per-teacher quality.

Counterpart of `raptor_tpu/apps/filter_teachers.py`, same flags, same output
pack and meta. Severity-heavy SAC waves leave some teachers unable to hover
their own airframe from a 0.2-rad start; in DAgger distillation their labels
are noise near hover. This tool subsets a pack to the teachers that pass
measured gates (an `apps/eval_teachers.py` report), producing a pack that
`load_teachers` accepts anywhere. It is the hover gate that made every pack
of the flagship recipe (`filter_teachers --max-term 0.5` on `eval_teachers
--max-angle 0.2` reports):

    python -m raptor_tpu_torch.apps.filter_teachers \
        artifacts/teachers_demo2500_30M.npz out.npz \
        --eval artifacts/eval_teachers_hover02.json --max-term 0.5

It reads and writes numpy only.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from raptor_tpu_torch.apps.pack_teachers import load_teacher_pack, save_teacher_pack


def filter_pack(pack_path: str, out_path: str, keep: np.ndarray, note: str) -> int:
    """Write the teachers of `pack_path` where `keep` [K] is true to
    `out_path`; returns how many were kept."""
    actors, frames = load_teacher_pack(pack_path)
    k = int(frames["mass"].shape[0])
    if keep.shape != (k,):
        raise ValueError(f"keep has shape {keep.shape}, the pack holds {k} teachers")
    idx = np.flatnonzero(keep)
    sub_actors = {"layers": [{"w": layer["w"][idx], "b": layer["b"][idx]}
                             for layer in actors["layers"]]}
    sub_frames = {f: v[idx] for f, v in frames.items()}
    save_teacher_pack(out_path, sub_actors, sub_frames,
                      meta={"filtered_from": pack_path, "note": note})
    return len(idx)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("pack")
    p.add_argument("out")
    p.add_argument("--eval", required=True,
                   help="eval_teachers JSON containing this pack's per_teacher_* arrays")
    p.add_argument("--max-term", type=float, default=None,
                   help="drop teachers with per_teacher_share_terminated >= this")
    p.add_argument("--min-return", type=float, default=None,
                   help="drop teachers with per_teacher_return < this")
    args = p.parse_args(argv)

    with open(args.eval) as f:
        report = json.load(f)
    if args.pack not in report:
        raise SystemExit(f"{args.eval} has no entry for {args.pack!r} (has: {list(report)})")
    d = report[args.pack]
    k = d["teachers"]
    keep = np.ones(k, bool)
    if args.max_term is not None:
        keep &= np.array(d["per_teacher_share_terminated"]) < args.max_term
    if args.min_return is not None:
        keep &= np.array(d["per_teacher_return"]) >= args.min_return
    note = f"max_term={args.max_term} min_return={args.min_return} eval={args.eval}"
    kept = filter_pack(args.pack, args.out, keep, note)
    print(f"{args.pack}: kept {kept}/{k} -> {args.out}")
    return kept


if __name__ == "__main__":
    main()
