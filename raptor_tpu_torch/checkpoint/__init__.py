"""Checkpoints, and the converters that carry numpy arrays (for example the
JAX package's parameters, airframes, states and teacher populations) onto a
device as the port's tensors."""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import numpy as np
import torch

from raptor_tpu_torch.env.types import DynamicsParams, State


def _tensor(x, device) -> torch.Tensor:
    return torch.as_tensor(np.array(x, np.float32), device=device)


def from_numpy(params_np, device) -> dict:
    """Policy parameters as a nested dict of arrays -> the same dict of f32
    tensors on `device`."""
    return {
        layer: {k: _tensor(v, device) for k, v in tensors.items()}
        for layer, tensors in params_np.items()
    }


def _dataclass_from_numpy(cls, src, device, probe: str, unbatched_ndim: int):
    def get(name):
        return src[name] if isinstance(src, Mapping) else getattr(src, name)

    unbatched = np.ndim(get(probe)) == unbatched_ndim
    out = {}
    for f in dataclasses.fields(cls):
        t = _tensor(get(f.name), device)
        out[f.name] = t[None] if unbatched else t
    return cls(**out)


def dynamics_params_from_numpy(src, device) -> DynamicsParams:
    """Airframe parameters given as arrays (a mapping, or any object with the
    field names as attributes) -> `DynamicsParams` on `device`. One unbatched
    airframe becomes a batch of one."""
    return _dataclass_from_numpy(DynamicsParams, src, device, "mass", 0)


def state_from_numpy(src, device) -> State:
    """A state given as arrays (mapping or attributes) -> `State` on `device`.
    One unbatched state becomes a batch of one."""
    return _dataclass_from_numpy(State, src, device, "position", 1)


def teachers_from_numpy(actors_np, airframes_np, device):
    """A teacher population given as arrays -> (stacked [K] actor dict
    {"layers": [{"w": [K, in, out], "b": [K, out]}, ...]}, `DynamicsParams`
    [K]) on `device`. `airframes_np` is a mapping or any object with the
    field names as attributes."""
    actors = {
        "layers": [
            {k: _tensor(layer[k], device) for k in ("w", "b")} for layer in actors_np["layers"]
        ]
    }
    return actors, dynamics_params_from_numpy(airframes_np, device)
