"""ui-server protocol: message builders for the 3D visualization.

Counterpart of the message builders of `raptor_tpu/env/ui.py`. The ui-server
protocol sends JSON channels after a handshake that carries a namespace:

    {"channel": "ui_message",           "data": {...ui spec/model override...}}
    {"channel": "parameters_message",   "data": {"namespace": ns, "parameters": [...]}}
    {"channel": "state_action_message", "data": {"namespace": ns, "states": [...], "actions": [...]}}

The builders are pure functions over the port's batched `DynamicsParams` and
`State`; for the same airframes and states their JSON equals the JAX
package's. The live websocket client is not ported yet.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from raptor_tpu_torch.env.io import params_to_dict
from raptor_tpu_torch.env.types import DynamicsParams, State, tree_map


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def ui_message(namespace: str, model_url: Optional[str] = None) -> dict:
    """UI setup; model_url optionally overrides the 3D model."""
    data: dict = {"namespace": namespace}
    if model_url is not None:
        data["model"] = model_url
    return {"channel": "ui_message", "data": data}


def parameters_message(namespace: str, params_stacked: DynamicsParams, n_envs: int) -> dict:
    """Per-env airframe parameters for render scaling."""
    parameters = []
    for i in range(n_envs):
        d = params_to_dict(tree_map(lambda x: x[i : i + 1], params_stacked))
        parameters.append(
            {
                "dynamics": {
                    "mass": d["mass"],
                    "rotor_positions": d["rotor_positions"],
                    "rotor_thrust_directions": d["rotor_thrust_directions"],
                }
            }
        )
    return {
        "channel": "parameters_message",
        "data": {"namespace": namespace, "parameters": parameters},
    }


def state_action_message(namespace: str, states: State, actions: Sequence[Sequence[float]]) -> dict:
    """Per-step state + action frame. `states` is the batched `State`;
    actions [N, 4]."""
    fields = {k: _np(getattr(states, k)) for k in (
        "position", "orientation", "linear_velocity", "angular_velocity", "rpm")}
    actions = _np(actions)
    n = fields["position"].shape[0]
    return {
        "channel": "state_action_message",
        "data": {"namespace": namespace,
                 "states": [{k: v[i].tolist() for k, v in fields.items()} for i in range(n)],
                 "actions": [actions[i].tolist() for i in range(n)]},
    }
