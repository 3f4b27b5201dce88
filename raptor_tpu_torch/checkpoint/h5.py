"""Policy checkpoints: the reference rl-tools HDF5 schema and the port's
`.npz` form of it.

Counterpart of `raptor_tpu/checkpoint/h5.py`. The HDF5 schema is

    actor/layers/0/{weights,biases}/parameters                  (out x in), (1, out)
    actor/layers/1/{weights_input,weights_hidden}/parameters    (3H, H)
    actor/layers/1/{biases_input,biases_hidden}/parameters      (3H,)
    actor/layers/1/initial_hidden_state/parameters              (H,)
    actor/layers/2/{weights,biases}/parameters
    example/input (T, B, obs), example/output (T, B, act)       golden I/O

The `.npz` form holds the same nine arrays under "<layer>/<name>" keys (as
`load_actor` returns them) and "example/input", "example/output". It needs
only numpy to read; h5py is imported only where an `.h5` file is touched.
Loaders return numpy arrays; `raptor_tpu_torch.checkpoint.from_numpy` puts
them on a device.

    python -m raptor_tpu_torch.checkpoint.h5 student.h5 student.npz
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from raptor_tpu_torch.policy import network

_LAYERS = {
    "dense_0": ("0", ("weights", "biases")),
    "gru_1": (
        "1",
        ("weights_input", "weights_hidden", "biases_input", "biases_hidden",
         "initial_hidden_state"),
    ),
    "dense_2": ("2", ("weights", "biases")),
}


def _is_npz(path: str) -> bool:
    return str(path).endswith(".npz")


def load_actor(path: str) -> Dict[str, Dict[str, np.ndarray]]:
    """Actor parameters as a nested dict of f32 numpy arrays."""
    if _is_npz(path):
        with np.load(path) as z:
            return {
                layer: {k: np.asarray(z[f"{layer}/{k}"], np.float32) for k in names}
                for layer, (_, names) in _LAYERS.items()
            }
    import h5py

    with h5py.File(path, "r") as f:
        layers = f["actor"]["layers"]
        params = {
            layer: {
                k: np.asarray(layers[idx][k]["parameters"], np.float32)
                for k in names
            }
            for layer, (idx, names) in _LAYERS.items()
        }
    for layer in ("dense_0", "dense_2"):  # biases are stored as (1, out)
        params[layer]["biases"] = params[layer]["biases"].reshape(-1)
    return params


def load_example_io(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Golden example I/O ([T, B, obs], [T, B, act])."""
    if _is_npz(path):
        with np.load(path) as z:
            return (
                np.asarray(z["example/input"], np.float32),
                np.asarray(z["example/output"], np.float32),
            )
    import h5py

    with h5py.File(path, "r") as f:
        return (
            np.asarray(f["example"]["input"], np.float32),
            np.asarray(f["example"]["output"], np.float32),
        )


def _numpy_params(params) -> Dict[str, Dict[str, np.ndarray]]:
    return {
        layer: {
            k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            .astype(np.float32)
            for k, v in tensors.items()
        }
        for layer, tensors in params.items()
    }


def _apply_sequence_cpu(p: Dict[str, Dict[str, np.ndarray]], obs: np.ndarray) -> np.ndarray:
    tp = {layer: {k: torch.from_numpy(v) for k, v in t.items()} for layer, t in p.items()}
    with torch.no_grad():
        _, out = network.apply_sequence(tp, torch.from_numpy(np.asarray(obs, np.float32)))
    return out.numpy()


def save_actor(
    path: str,
    params,
    example_input: Optional[np.ndarray] = None,
    example_output: Optional[np.ndarray] = None,
    checkpoint_name: str = "",
    meta: Optional[dict] = None,
) -> None:
    """Write actor parameters (+ golden I/O): the `.npz` form for a path
    ending in `.npz`, else the HDF5 schema.

    Without example vectors, [500, 2, obs] N(0, 1) inputs are drawn and run
    through the policy, as the reference does at export."""
    p = _numpy_params(params)
    if example_input is None:
        rng = np.random.default_rng(0)
        obs_dim = p["dense_0"]["weights"].shape[1]
        example_input = rng.standard_normal((500, 2, obs_dim)).astype(np.float32)
    if example_output is None:
        example_output = _apply_sequence_cpu(p, example_input)
    if meta is None:
        meta = {
            "environment": {
                "name": "l2f",
                "observation": "Position.OrientationRotationMatrix.LinearVelocity."
                "AngularVelocityDelayed(0).ActionHistory(1)",
            }
        }
    example_input = np.asarray(example_input, np.float32)
    example_output = np.asarray(example_output, np.float32)

    if _is_npz(path):
        arrays = {f"{layer}/{k}": v for layer, t in p.items() for k, v in t.items()}
        arrays["example/input"] = example_input
        arrays["example/output"] = example_output
        with open(path, "wb") as fh:
            np.savez(fh, **arrays)
        return

    import h5py

    with h5py.File(path, "w") as f:
        actor = f.create_group("actor")
        actor.attrs["type"] = "sequential"
        actor.attrs["checkpoint_name"] = checkpoint_name
        actor.attrs["meta"] = json.dumps(meta)
        layers = actor.create_group("layers")
        for layer, (idx, names) in _LAYERS.items():
            g = layers.create_group(idx)
            for k in names:
                v = p[layer][k]
                if k == "biases":
                    v = v.reshape(1, -1)
                g.create_group(k).create_dataset("parameters", data=v)
        ex = f.create_group("example")
        ex.create_dataset("input", data=example_input)
        ex.create_dataset("output", data=example_output)


def load_mlp_actor(path: str) -> Dict[str, list]:
    """A feedforward (teacher) actor from an HDF5 checkpoint:
    {"layers": [{"w": [in, out], "b": [out]}, ...]} as f32 numpy arrays."""
    import h5py

    with h5py.File(path, "r") as f:
        layers_g = f["actor"]["layers"]
        layers = [
            {
                "w": np.asarray(layers_g[i]["weights"]["parameters"], np.float32),
                "b": np.asarray(layers_g[i]["biases"]["parameters"], np.float32),
            }
            for i in sorted(layers_g.keys(), key=int)
        ]
    return {"layers": layers}


def verify_checkpoint(path: str, atol: float = 1e-3) -> float:
    """Replay the embedded golden I/O through the policy (f32, CPU) and return
    the max abs error; raises ValueError above `atol`."""
    ex_in, ex_out = load_example_io(path)
    err = float(np.max(np.abs(_apply_sequence_cpu(load_actor(path), ex_in) - ex_out)))
    if not err <= atol:
        raise ValueError(f"checkpoint self-test failed: max abs err {err} > {atol}")
    return err


def to_npz(h5_path: str, npz_path: str) -> None:
    """Write the `.npz` form of an HDF5 checkpoint (weights + golden I/O)."""
    ex_in, ex_out = load_example_io(h5_path)
    save_actor(npz_path, load_actor(h5_path), ex_in, ex_out)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="convert an .h5 policy checkpoint to .npz")
    p.add_argument("h5_path")
    p.add_argument("npz_path")
    args = p.parse_args(argv)
    to_npz(args.h5_path, args.npz_path)
    err = verify_checkpoint(args.npz_path, atol=float("inf"))
    print(f"{args.npz_path}: golden I/O max abs err {err:.3e} (f32, CPU)")


if __name__ == "__main__":
    main()
