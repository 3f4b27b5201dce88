"""Pack / unpack a teacher population as one compressed `.npz`.

Counterpart of `raptor_tpu/apps/pack_teachers.py`, same file format: stacked
[K] actor layers under `actor/layers/{i}/{w,b}`, stacked [K] airframe fields
under `airframe/{field}`, and a JSON `meta` with the format version and K. A
pack needs only numpy to read. `load_teacher_pack` returns numpy arrays;
`raptor_tpu_torch.checkpoint.teachers_from_numpy` puts them on a device.

    python -m raptor_tpu_torch.apps.pack_teachers pack <checkpoints.txt> <out.npz>
    python -m raptor_tpu_torch.apps.pack_teachers info <pack.npz>
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from raptor_tpu_torch.env.io import _FIELDS

PACK_VERSION = 1


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float32)


def save_teacher_pack(path: str, teacher_actors, airframes, meta: Optional[dict] = None) -> None:
    """teacher_actors: stacked [K] MLP dict {"layers": [{w, b}, ...]};
    airframes: stacked [K] `DynamicsParams` (or a mapping of its fields)."""
    arrays = {}
    for i, layer in enumerate(teacher_actors["layers"]):
        arrays[f"actor/layers/{i}/w"] = _np(layer["w"])
        arrays[f"actor/layers/{i}/b"] = _np(layer["b"])
    for f in _FIELDS:
        arrays[f"airframe/{f}"] = _np(airframes[f] if isinstance(airframes, dict)
                                      else getattr(airframes, f))
    k = arrays["airframe/mass"].shape[0]
    arrays["meta"] = np.frombuffer(
        json.dumps({"version": PACK_VERSION, "n_teachers": int(k), **(meta or {})}).encode(),
        dtype=np.uint8,
    )
    with open(path, "wb") as fh:
        np.savez_compressed(fh, **arrays)


def load_teacher_pack(path: str) -> Tuple[dict, Dict[str, np.ndarray]]:
    """(teacher_actors, airframes) as numpy: {"layers": [{w [K, in, out],
    b [K, out]}, ...]} and {field: [K, ...]}.

    Verifies on load: the embedded meta must parse, carry a known version and
    agree with the loaded K, so a truncated, corrupt or future-format pack
    raises instead of loading silently."""
    with np.load(path) as z:
        try:
            meta = json.loads(bytes(z["meta"]).decode())
        except (KeyError, ValueError) as e:
            raise ValueError(
                f"teacher pack {path!r} has no parseable meta: truncated or not a "
                f"teacher pack ({e})"
            ) from e
        if meta.get("version") != PACK_VERSION:
            raise ValueError(
                f"teacher pack {path!r} is format version {meta.get('version')!r}; "
                f"this build reads version {PACK_VERSION}"
            )
        n_layers = sum(1 for k in z.files if k.endswith("/w"))
        layers = [
            {k: np.asarray(z[f"actor/layers/{i}/{k}"], np.float32) for k in ("w", "b")}
            for i in range(n_layers)
        ]
        airframes = {f: np.asarray(z[f"airframe/{f}"], np.float32) for f in _FIELDS}
    k = int(airframes["mass"].shape[0])
    if meta.get("n_teachers") != k:
        raise ValueError(
            f"teacher pack {path!r}: meta says {meta.get('n_teachers')} teachers but "
            f"arrays hold {k}"
        )
    return {"layers": layers}, airframes


def pack_info(path: str) -> dict:
    with np.load(path) as z:
        meta = json.loads(bytes(z["meta"]).decode())
        meta["actor_param_count_per_teacher"] = int(
            sum(int(np.prod(z[k].shape[1:])) for k in z.files if k.startswith("actor/"))
        )
    return meta


def main(argv=None):
    p = argparse.ArgumentParser()
    sub = p.add_subparsers(dest="cmd", required=True)
    pp = sub.add_parser("pack")
    pp.add_argument("manifest", help="checkpoints.txt")
    pp.add_argument("out", help="output .npz path")
    ip = sub.add_parser("info")
    ip.add_argument("pack", help=".npz path")
    args = p.parse_args(argv)

    if args.cmd == "pack":
        from raptor_tpu_torch.apps.post_training import load_teachers

        teacher_actors, airframes = load_teachers(args.manifest, "cpu")
        save_teacher_pack(args.out, teacher_actors, airframes,
                          meta={"source_manifest": args.manifest})
        print(json.dumps(pack_info(args.out)))
    else:
        print(json.dumps(pack_info(args.pack)))


if __name__ == "__main__":
    main()
