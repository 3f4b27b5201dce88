"""ui-server protocol: message builders for the 3D visualization.

Counterpart of the message builders of `raptor_tpu/env/ui.py`. The ui-server
protocol sends JSON channels after a handshake that carries a namespace:

    {"channel": "ui_message",           "data": {...ui spec/model override...}}
    {"channel": "parameters_message",   "data": {"namespace": ns, "parameters": [...]}}
    {"channel": "state_action_message", "data": {"namespace": ns, "states": [...], "actions": [...]}}

The builders are pure functions over the port's batched `DynamicsParams` and
`State`; for the same airframes and states their JSON equals the JAX
package's. `UIClient` drives a live server (`apps/ui_server.py`, or the
reference's `ui-server`); it imports `websockets` when it connects, so the
builders need no network package.
"""

from __future__ import annotations

import json
from typing import Optional, Sequence

import numpy as np
import torch

from raptor_tpu_torch.env.io import params_to_dict
from raptor_tpu_torch.env.types import DynamicsParams, State, tree_map


DEFAULT_URL = "ws://localhost:13337/backend"


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


class UIClient:
    """Async client for a live ui-server:

        async with UIClient() as ui:
            await ui.set_parameters(params, n_envs=8)
            await ui.render(states, actions)
    """

    def __init__(self, url: str = DEFAULT_URL):
        self.url = url
        self.namespace: Optional[str] = None
        self._ws = None

    async def __aenter__(self):
        import websockets

        self._ws = await websockets.connect(self.url)
        handshake = json.loads(await self._ws.recv())
        self.namespace = handshake.get("data", {}).get("namespace", "default")
        return self

    async def __aexit__(self, *exc):
        if self._ws is not None:
            await self._ws.close()

    async def send(self, message: dict):
        await self._ws.send(json.dumps(message))

    async def set_ui(self, model_url: Optional[str] = None):
        await self.send(ui_message(self.namespace, model_url))

    async def set_parameters(self, params_stacked: DynamicsParams, n_envs: int):
        await self.send(parameters_message(self.namespace, params_stacked, n_envs))

    async def render(self, states: State, actions):
        await self.send(state_action_message(self.namespace, states, actions))
