"""Time the rollout (B1), eval (B2) and collect (B3) kernels of two checkouts
of the repo on one GPU, their runs interleaved:

    python -m raptor_tpu_torch.apps.kernel_ab --parent build/ab_parent [--runs 10] [--out ab.json]

`--parent` is the root of another checkout's package (for instance
`git archive <commit> raptor_tpu_torch` unpacked into a directory that
`.gitignore` lists); the change is the checkout this module lies in. Both
sides build their kernels into their own `build/` at once, and each build
reports ptxas' registers and spills of every rollout, eval and collect
instantiation (`team_sweep.ptxas_counts`, hidden widths 8 to 48) and the
SASS instruction counts of `rollout_kernel`, `eval_kernel<16>` and
`collect_kernel<16>`. Then the sides run in turn, parent first (p c p c
...), `--runs` processes a side. Each runs `team_sweep`'s worker of its own
side, which holds the side's kernels against their plain versions and
times them (CUDA-event median of 5 launches after a warm-up) at
`chip_smoke.py` phase 12's shapes: B2 on the committed student at 2,048
random airframes x 8 envs = 16,384 from the eval-parity init, B3 at 5,528
and 944 random airframes (the envs of the 691-teacher union and of a
distillation round), 500 steps each, and B1 at 16,384 random airframes
(512 steps with termination off, and at hover). The same process then
times B2 at every built width over those envs with termination off (a
student from the width's seed; every env flies all 500 steps) and digests
B2's outputs (state and stats, SHA-256) there and with the default bounds,
and on the committed student at the main-path shape, so the report says
whether the two sides' B2 agree bit for bit.
The report gives each side's median, min and max over its runs at each
shape, the pairs of runs, and the verdict of the rule (`verdict`).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

from raptor_tpu_torch.apps.team_sweep import ptxas_counts

CHANGE_ROOT = Path(__file__).resolve().parents[2]
WIDTHS = (8, 16, 24, 32, 48)
# shape -> the key of a run's report that times it
SHAPES = {"eval_16384": "eval_ms", "collect_5528": "collect_ms", "collect_944": "collect_944_ms",
          "rollout_off": "rollout_off_ms", "rollout_hover": "rollout_hover_ms",
          **{f"eval_off_{h}": f"eval_off_{h}_ms" for h in WIDTHS}}
BUILD = ("import json; from raptor_tpu_torch.ops import build; "
         "sass = {k: build.cuda_sass_counts(k.replace('<16>', 'ILi16E')) "
         "for k in ('rollout_kernel', 'eval_kernel<16>', 'collect_kernel<16>')}; "
         "print(json.dumps({'log': build.cuda_build_log(), 'sass': sass}))")
# one run of a side: team_sweep's worker, then B2 at every width (APIs both
# sides have)
RUN = '''
import hashlib, json, torch
from raptor_tpu_torch.apps import team_sweep
from raptor_tpu_torch.checkpoint import from_numpy, h5
from raptor_tpu_torch.env import EnvConfig, L2F, eval_parity_init
from raptor_tpu_torch.env.randomization import sample_population
from raptor_tpu_torch.env.types import tree_map
from raptor_tpu_torch.ops import eval as ops_eval
from raptor_tpu_torch.policy import network

def digest(out):
    return hashlib.sha256(b"".join(t.cpu().numpy().tobytes() for t in out)).hexdigest()[:16]

res = team_sweep.worker()
dev = torch.device("cuda", 0)
frames = tree_map(lambda x: x.repeat_interleave(8, 0),
                  sample_population(torch.Generator(device=dev).manual_seed(0), 2048))
es, _ = L2F(EnvConfig(init=eval_parity_init())).reset(
    frames, torch.Generator(device=dev).manual_seed(1))
ps, ss = frames.to_soa(), es.dynamics.to_soa()
off = dict(pos_bound=1e9, linvel_bound=1e9, angvel_bound=1e9)
student = from_numpy(h5.load_actor("raptor_tpu_torch/data/student_rateFlagCurMix.npz"), dev)
res["eval_main_digest"] = [digest(ops_eval.eval_soa(ops_eval.flatten_policy(student), ps, ss, 500))]
for h in %r:
    w = ops_eval.flatten_policy(network.init_params(
        torch.Generator(device=dev).manual_seed(h), hidden_dim=h))
    res[f"eval_off_{h}_ms"] = team_sweep._time_ms(
        torch, lambda: ops_eval.eval_soa(w, ps, ss, 500, **off))
    res[f"eval_{h}_digest"] = [digest(ops_eval.eval_soa(w, ps, ss, 500, **off)),
                               digest(ops_eval.eval_soa(w, ps, ss, 500))]
print(json.dumps(res))
''' % (WIDTHS,)


def _python(root: Path, *args: str) -> subprocess.Popen:
    """A process of the side at `root`: its package first on the path."""
    return subprocess.Popen([sys.executable, *args], cwd=root, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            env=dict(os.environ, PYTHONPATH=str(root)))


def _last_json(proc: subprocess.Popen, what: str, timeout: int = 900) -> dict:
    out, err = proc.communicate(timeout=timeout)
    if proc.returncode:
        raise RuntimeError(f"{what}: exit {proc.returncode}\n{err[-3000:]}")
    return json.loads(out.strip().splitlines()[-1])


def summary(runs):
    """Median, min and max of each shape over a side's runs ({shape: ms})."""
    out = {}
    for shape in SHAPES:
        xs = [r["ms"][shape] for r in runs]
        out[shape] = {"median": statistics.median(xs), "min": min(xs), "max": max(xs), "runs": xs}
    return out


def verdict(parent: dict, change: dict, p_ptxas: dict, c_ptxas: dict) -> dict:
    """The rule fixed before the runs: at each shape the change's median lies
    within the parent's [min, max] or at most 1 % above the parent's median,
    and no instantiation has more registers or more spill bytes."""
    shapes = {}
    for shape in SHAPES:
        p, c = parent[shape], change[shape]
        shapes[shape] = (p["min"] <= c["median"] <= p["max"]
                         or c["median"] <= 1.01 * p["median"])
    worse = sorted(k for k in c_ptxas if k in p_ptxas and (
        c_ptxas[k][0] > p_ptxas[k][0] or c_ptxas[k][1] > p_ptxas[k][1]))
    missing = sorted(set(p_ptxas) ^ set(c_ptxas))
    return {"shapes": shapes, "registers_or_spills_worse": worse, "unmatched_kernels": missing,
            "lands": all(shapes.values()) and not worse and not missing}


def digests(runs) -> dict:
    """Width -> the set of B2's output digests over a side's runs."""
    return {h: sorted({tuple(r["digest"][h]) for r in runs}) for h in runs[0]["digest"]}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--parent", required=True, help="root of the other checkout's package")
    p.add_argument("--runs", type=int, default=10, help="processes a side (at least 5)")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if args.runs < 5:
        raise ValueError("--runs must be at least 5")

    sides = {"parent": Path(args.parent).resolve(), "change": CHANGE_ROOT}
    builds = {name: _python(root, "-c", BUILD) for name, root in sides.items()}
    built = {name: _last_json(proc, f"{name} build") for name, proc in builds.items()}
    ptxas = {name: ptxas_counts(b["log"]) for name, b in built.items()}
    sass = {name: b["sass"] for name, b in built.items()}
    print(json.dumps({"sass": sass}), flush=True)
    runs = {"parent": [], "change": []}
    for _ in range(args.runs):
        for name, root in sides.items():
            res = _last_json(_python(root, "-c", RUN), f"{name} run")
            runs[name].append({"ms": {shape: res[key] for shape, key in SHAPES.items()},
                               "digest": {str(h): res[f"eval_{h}_digest"]
                                          for h in ("main", *WIDTHS)}})
            print(json.dumps({"side": name, **runs[name][-1]}), flush=True)
    from raptor_tpu_torch.apps.roofline import card_name_and_power_limit

    stats = {name: summary(r) for name, r in runs.items()}
    sums = {name: digests(r) for name, r in runs.items()}
    slower = {shape: sum(c["ms"][shape] > q["ms"][shape]
                         for q, c in zip(runs["parent"], runs["change"])) for shape in SHAPES}
    report = {
        "card": card_name_and_power_limit(), "order": " ".join("p c".split() * args.runs),
        "ms": stats, "change_slower_in_pairs": slower, "ptxas": ptxas, "sass": sass,
        "eval_digests": sums, "eval_bit_equal": sums["parent"] == sums["change"],
        "verdict": verdict(stats["parent"], stats["change"], ptxas["parent"], ptxas["change"]),
    }
    if args.out:
        Path(args.out).write_text(json.dumps(report, indent=2) + "\n")
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
