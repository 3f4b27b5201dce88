"""CLI: render the distillation learning-curve comparison figure.

Counterpart of `raptor_tpu/apps/plot_curves.py`. Ours-vs-reference over
env-steps for the two protocol-comparable metrics (episode length and
termination share: return scales are not comparable, because the
reference's reward constants are unknown). Reads our post-training tfevents
(one or more runs) and the shipped reference log
(`apps.compare_baseline.reference_log_path`); writes a two-panel PNG.

    python -m raptor_tpu_torch.apps.plot_curves artifacts/distill_640teachers.tfevents \
        --label "ours (640 teachers)" --out curves.png

matplotlib is imported when the figure is drawn, so the package imports
without it.
"""

from __future__ import annotations

import argparse

from raptor_tpu_torch.apps import compare_baseline
from raptor_tpu_torch.utils.tfevents import read_scalars

# chart roles, light mode: categorical slots in fixed order
SURFACE = "#fcfcfb"
TEXT_PRIMARY = "#0b0b0b"
TEXT_SECONDARY = "#52514e"
GRID = "#e4e3df"
SERIES = ["#2a78d6", "#1baf7a", "#4a3aa7"]  # ours: blue, aqua, violet
REFERENCE_COLOR = "#eb6834"  # orange: the reference is always slot 2


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("events", nargs="+", help="our post-training tfevents file(s)")
    p.add_argument("--label", action="append", default=None,
                   help="legend label per events file")
    p.add_argument("--out", default="artifacts/curves.png")
    args = p.parse_args(argv)

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    labels = args.label or [f"ours ({i})" for i in range(len(args.events))]
    runs = [(lab, read_scalars(ev)) for lab, ev in zip(labels, args.events)]
    ref = read_scalars(compare_baseline.reference_log_path())

    panels = [
        ("evaluation/episode_length/mean", "episode length (of 500 steps)"),
        ("evaluation/share_terminated", "share terminated"),
    ]
    fig, axes = plt.subplots(1, 2, figsize=(11, 4.2), facecolor=SURFACE)
    for ax, (tag, title) in zip(axes, panels):
        ax.set_facecolor(SURFACE)
        rs, rv = zip(*ref[tag])
        ax.plot([s / 1e6 for s in rs], rv, color=REFERENCE_COLOR, lw=2,
                label="reference (shipped log)")
        for (lab, run), color in zip(runs, SERIES):
            if tag not in run:
                continue
            os_, ov = zip(*run[tag])
            ax.plot([s / 1e6 for s in os_], ov, color=color, lw=2, label=lab)
            # selective direct label: final value only
            ax.annotate(f"{ov[-1]:.3g}", (os_[-1] / 1e6, ov[-1]),
                        textcoords="offset points", xytext=(4, -2),
                        color=TEXT_PRIMARY, fontsize=9)
        ax.annotate(f"{rv[-1]:.3g}", (rs[-1] / 1e6, rv[-1]),
                    textcoords="offset points", xytext=(4, 4),
                    color=TEXT_PRIMARY, fontsize=9)
        ax.set_title(title, color=TEXT_PRIMARY, fontsize=11, loc="left")
        ax.set_xlabel("env-steps (millions)", color=TEXT_SECONDARY, fontsize=9)
        ax.tick_params(colors=TEXT_SECONDARY, labelsize=8)
        ax.grid(True, color=GRID, lw=0.6)
        for s in ("top", "right"):
            ax.spines[s].set_visible(False)
        for s in ("left", "bottom"):
            ax.spines[s].set_color(GRID)
    axes[0].set_ylim(0, 520)
    axes[1].set_ylim(0, 1.0)
    axes[0].legend(loc="lower right", fontsize=9, frameon=False,
                   labelcolor=TEXT_PRIMARY)
    fig.suptitle(
        "Distillation quality vs env-steps — eval-parity protocol "
        "(init attitudes ≤ 1.0 rad, 500-step episodes)",
        color=TEXT_PRIMARY, fontsize=12, x=0.01, ha="left",
    )
    fig.tight_layout(rect=(0, 0, 1, 0.93))
    fig.savefig(args.out, dpi=160, facecolor=SURFACE)
    plt.close(fig)
    print(args.out)
    return args.out


if __name__ == "__main__":
    main()
