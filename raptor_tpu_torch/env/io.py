"""Dynamics-parameter JSON serialization: one JSON object per airframe,
round-trippable to `DynamicsParams`.

Counterpart of `raptor_tpu/env/io.py` (the `dynamics_parameters/{i}.json`
files the pre-training stage reads). One file holds one airframe; in the port
that is a `DynamicsParams` batch of one.
"""

from __future__ import annotations

import json

import numpy as np

from raptor_tpu_torch.env.types import DynamicsParams

_FIELDS = [
    "mass",
    "inertia_diag",
    "inertia_diag_inv",
    "rotor_positions",
    "rotor_thrust_directions",
    "rotor_torque_signs",
    "thrust_curve",
    "torque_constant",
    "rpm_min",
    "rpm_max",
    "motor_time_constant",
    "disturbance_force_std",
    "disturbance_torque_std",
]


def params_to_dict(params: DynamicsParams) -> dict:
    """One airframe (a batch of one) as a dict of nested lists without the
    batch axis."""
    if params.mass.shape[0] != 1:
        raise ValueError(f"one airframe per file, got a batch of {params.mass.shape[0]}")
    return {f: getattr(params, f)[0].detach().cpu().numpy().tolist() for f in _FIELDS}


def params_from_dict(d: dict, device) -> DynamicsParams:
    from raptor_tpu_torch.checkpoint import dynamics_params_from_numpy

    return dynamics_params_from_numpy({f: np.asarray(d[f], np.float32) for f in _FIELDS}, device)


def save_params_json(path: str, params: DynamicsParams) -> None:
    with open(path, "w") as f:
        json.dump(params_to_dict(params), f, indent=2)


def load_params_numpy(path: str) -> dict:
    """One airframe file as a dict of f32 numpy arrays without the batch axis."""
    with open(path) as f:
        d = json.load(f)
    return {f: np.asarray(d[f], np.float32) for f in _FIELDS}


def load_params_json(path: str, device) -> DynamicsParams:
    return params_from_dict(load_params_numpy(path), device)
