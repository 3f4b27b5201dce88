"""Aggregate eval-parity artifacts into one comparison table (a copy of
`tools/parity_table.py`, which needs the standard library only).

Scans artifacts/eval_parity_*.json (the apps/eval_parity sweep format) and
emits a markdown table of the student rows at the protocol angles that
matter (eval-parity 1.0 rad, stress 1.5/2.0, and pi starts), sorted by
pi-aggregate episode length; reference envelope from BASELINE.md rows 21-27.

    python -m raptor_tpu_torch.tools.parity_table [--out compare.md]

Prints the table; writes it only where `--out` names a file.
"""

from __future__ import annotations

import argparse
import glob
import json
import os

ANGLES = (1.0, 1.5, 2.0, 3.14159)


def load_rows(pattern: str = "artifacts/eval_parity_*.json"):
    runs = []
    for path in sorted(glob.glob(pattern)):
        tag = os.path.basename(path)[len("eval_parity_"):-len(".json")]
        with open(path) as f:
            d = json.load(f)
        row = {"tag": tag}
        ok = False
        for r in d.get("sweep", []):
            for a in ANGLES:
                if abs(r.get("max_angle", -1) - a) < 1e-3:
                    sa = r.get("student_aggregate")
                    sc = r.get("student_crazyflie")
                    if sa:
                        row[(a, "agg")] = (sa["episode_length"],
                                           sa["share_terminated"])
                        ok = True
                    if sc:
                        row[(a, "cf")] = (sc["episode_length"],
                                          sc["share_terminated"])
        if ok:
            runs.append(row)
    runs.sort(key=lambda r: -r.get((3.14159, "agg"), (0, 0))[0])
    return runs


def fmt(cell) -> str:
    if cell is None:
        return "—"
    length, term = cell
    return f"{length:.1f} @ {term * 100:.1f}%"


def render(runs) -> str:
    lines = [
        "| run | parity 1.0 agg | 1.5 agg | 2.0 agg | π agg | π crazyflie |",
        "|---|---|---|---|---|---|",
    ]
    for r in runs:
        lines.append(
            "| {tag} | {p} | {s15} | {s20} | {pa} | {pc} |".format(
                tag=r["tag"],
                p=fmt(r.get((1.0, "agg"))),
                s15=fmt(r.get((1.5, "agg"))),
                s20=fmt(r.get((2.0, "agg"))),
                pa=fmt(r.get((3.14159, "agg"))),
                pc=fmt(r.get((3.14159, "cf"))),
            )
        )
    return "\n".join(lines)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", default=None)
    p.add_argument("--pattern", default="artifacts/eval_parity_*.json")
    args = p.parse_args(argv)
    table = render(load_rows(args.pattern))
    print(table)
    if args.out:
        with open(args.out, "w") as f:
            f.write("# Student comparison — eval-parity sweeps\n\n"
                    "Sorted by π-aggregate episode length; student rows "
                    "only (reference envelope: BASELINE.md).\n\n")
            f.write(table + "\n")
        print(f"\nwrote {args.out}")


if __name__ == "__main__":
    main()
