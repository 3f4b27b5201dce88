"""CLI: export a policy checkpoint (.h5 or .npz) as a compiled-in C/C++
header, the firmware deployment path.

Counterpart of `raptor_tpu/apps/export_policy.py`, same flags, checks and
output lines. Two formats:
  --format raptor   (default) dependency-free C++ header with an embedded
                    golden-I/O self-test (checkpoint/code_export.py)
  --format rltools  upstream `rl_tools::checkpoint` namespace header,
                    compilable into unmodified rl-tools firmware
                    (checkpoint/rltools_export.py)

    python -m raptor_tpu_torch.apps.export_policy student.npz policy.h --format rltools

The exporter runs on the host by nature: the golden input is replayed on
the CPU in f32, whatever devices the machine has.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from raptor_tpu_torch.checkpoint import code_export, h5, rltools_export


def _replay_cpu(params, example_input: np.ndarray) -> np.ndarray:
    """The golden input through the policy in f32 on the CPU."""
    return h5._apply_sequence_cpu(
        {layer: {k: np.array(v, np.float32) for k, v in t.items()} for layer, t in params.items()},
        np.array(example_input, np.float32))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("checkpoint", help="policy checkpoint, .h5 or .npz")
    p.add_argument("out", help="output header path")
    p.add_argument("--format", choices=("raptor", "rltools"), default="raptor")
    p.add_argument("--name", default=None, help="meta name embedded in the header")
    args = p.parse_args(argv)

    params = h5.load_actor(args.checkpoint)
    ei, eo = h5.load_example_io(args.checkpoint)
    name = args.name or args.checkpoint
    # Recompute the golden outputs with the deployment-side path (f32 on the
    # CPU, as the firmware computes) before embedding them. This is the
    # exporter's contract, not a fallback: a checkpoint saved on another
    # device carries outputs that drift over 500 recurrent steps when
    # replayed on CPU or firmware f32, which would trip the embedded boot
    # self-test (native/executor.cpp, tolerance 1e-4). The checkpoint-vs-local
    # drift stays an informational cross-platform check; above 1e-3 the
    # checkpoint is taken for corrupt.
    eo_local = _replay_cpu(params, ei)
    drift = float(np.max(np.abs(eo_local - np.asarray(eo, np.float32))))
    if drift > 1e-3:
        print(f"WARNING: checkpoint golden-I/O drift {drift:.2e} vs local "
              "replay — checkpoint may be corrupt", file=sys.stderr)
        raise SystemExit(2)
    if args.format == "rltools":
        rltools_export.export_rltools_header(args.out, params, ei, eo_local, name=name)
        # self-verify: the re-import must be bit-exact and reproduce the golden I/O
        got, gi, go = rltools_export.import_rltools_header(args.out)
        err = float(np.max(np.abs(_replay_cpu(got, gi) - go)))
        if not np.array_equal(gi, np.asarray(ei, np.float32)):
            raise ValueError(f"{args.out}: the re-imported example input differs")
        print(f"{args.out}  format=rltools  self-test max-err: {err:.2e}  "
              f"cross-platform drift: {drift:.2e}")
        if not err < 1e-5:
            raise ValueError(f"{args.out}: rltools self-test max-err {err:.2e} >= 1e-5")
    else:
        code_export.export_header_file(args.out, params, ei, eo_local)
        print(f"{args.out}  format=raptor  cross-platform drift: {drift:.2e}")


if __name__ == "__main__":
    main()
