"""l2f-compatible Python API shim.

Counterpart of `raptor_tpu/env/l2f_compat.py`: the `l2f` / `l2f.vector8`
pip-package surface of the reference README, so reference user code ports
with renamed imports only:

    from raptor_tpu_torch.env import l2f_compat as l2f
    vector = l2f.vector8                      # or l2f.vector(N)

    device = l2f.Device()                     # the card; l2f.Device("cpu") for the CPU
    rng = vector.VectorRng()
    env = vector.VectorEnvironment()
    params = vector.VectorParameters()
    state, next_state = vector.VectorState(), vector.VectorState()
    obs = np.zeros((env.N_ENVIRONMENTS, env.OBSERVATION_DIM), np.float32)

    l2f.initialize_rng(device, rng, seed)
    l2f.initialize_environment(device, env)
    l2f.sample_initial_parameters(device, env, params, rng)
    l2f.sample_initial_state(device, env, params, state, rng)
    l2f.observe(device, env, params, state, obs, rng)
    dts = l2f.step(device, env, params, state, action, next_state, rng)
    state.assign(next_state)

Under the hood is the port's batched `L2F`; the mutable-looking objects are
thin containers over its [N]-batched tensors on the `Device`. A `VectorRng`
holds a `torch.Generator` on that device, seeded by `initialize_rng`; where
the JAX shim splits its key, the port draws from the generator. `vector8`
fixes N_ENVIRONMENTS = 8 like the reference wheel; `vector(N)` generalizes.
"""

from __future__ import annotations

import json
import types
from typing import Optional

import numpy as np
import torch

from raptor_tpu_torch.device import resolve_device
from raptor_tpu_torch.env import ui as ui_mod
from raptor_tpu_torch.env.quad import L2F
from raptor_tpu_torch.env.randomization import sample_population
from raptor_tpu_torch.env.types import EnvConfig


class Device:
    """Device tag (the reference's rlt device concept): the card unless
    `platform` names another torch device, such as "cpu"."""

    def __init__(self, platform: Optional[str] = None):
        self.platform = platform
        self.device = resolve_device(platform or "cuda")


class _StateView:
    """Attribute view of one env's state (reference `.states[i].position`)."""

    def __init__(self, parent, i):
        self._parent, self._i = parent, i

    def _field(self, name):
        return getattr(self._parent.dynamics, name)[self._i].detach().cpu().numpy()

    @property
    def position(self):
        return self._field("position")

    @property
    def orientation(self):
        return self._field("orientation")

    @property
    def linear_velocity(self):
        return self._field("linear_velocity")

    @property
    def angular_velocity(self):
        return self._field("angular_velocity")

    @property
    def rpm(self):
        return self._field("rpm")


def _make_vector_module(n_environments: int, config: EnvConfig = EnvConfig()):
    env_impl = L2F(config)
    mod = types.SimpleNamespace()
    mod.N_ENVIRONMENTS = n_environments

    class VectorRng:
        """A `torch.Generator` on the `Device`, made by `initialize_rng` (or,
        seeded 0, by the first call that draws)."""

        def __init__(self):
            self._generator: Optional[torch.Generator] = None

        def generator(self, device: Device) -> torch.Generator:
            if self._generator is None:
                initialize_rng(device, self, 0)
            return self._generator

    class VectorEnvironment:
        N_ENVIRONMENTS = n_environments
        OBSERVATION_DIM = env_impl.OBSERVATION_DIM
        ACTION_DIM = 4
        EPISODE_LENGTH = env_impl.EPISODE_LENGTH

        def __init__(self):
            self.impl = env_impl

    class VectorParameters:
        def __init__(self):
            self.stacked = None

        def assign(self, other: "VectorParameters"):
            self.stacked = other.stacked

    class VectorState:
        """Carries the batched dynamics `State` plus the observation histories
        the configured observation needs (`quad.EnvState` semantics:
        oldest-first ActionHistory(h) and AngularVelocityDelayed(d) rings).
        Empty until `sample_initial_state` fills it on the device."""

        def __init__(self):
            self.dynamics = None
            self.action_history: Optional[torch.Tensor] = None  # [N, h, 4]
            self.angvel_history: Optional[torch.Tensor] = None  # [N, d+1, 3]

        @property
        def prev_action(self):
            return self.action_history[:, -1]

        @property
        def states(self):
            return [_StateView(self, i) for i in range(n_environments)]

        def assign(self, other: "VectorState"):
            self.dynamics = other.dynamics
            self.action_history = other.action_history
            self.angvel_history = other.angvel_history

    mod.VectorRng = VectorRng
    mod.VectorEnvironment = VectorEnvironment
    mod.VectorParameters = VectorParameters
    mod.VectorState = VectorState
    mod._env_impl = env_impl
    return mod


vector8 = _make_vector_module(8)


def vector(n_environments: int, config: EnvConfig = EnvConfig()):
    return _make_vector_module(n_environments, config)


# -- free functions (the reference README's loop) ---------------------------


def initialize_rng(device: Device, rng, seed: int):
    rng._generator = torch.Generator(device=device.device).manual_seed(int(seed))


def initialize_environment(device: Device, env):
    pass  # the environment holds no state; construction happened in the module


def sample_initial_parameters(device: Device, env, params, rng):
    params.stacked = sample_population(rng.generator(device), env.N_ENVIRONMENTS)


def sample_initial_state(device: Device, env, params, state, rng):
    n = env.N_ENVIRONMENTS
    cfg = env.impl.config.observation
    state.dynamics = env.impl.sample_state(params.stacked, rng.generator(device))
    state.action_history = torch.zeros(
        (n, cfg.action_history_length, 4), device=device.device)
    # pre-fill the delay ring with the true initial angular velocity (quad.reset)
    state.angvel_history = state.dynamics.angular_velocity[:, None].expand(
        n, cfg.angular_velocity_delay + 1, 3).contiguous()


def observe(device: Device, env, params, state, observation: np.ndarray, rng):
    obs = env.impl.observe(
        params.stacked, state.dynamics, state.action_history, state.angvel_history)
    observation[...] = obs.cpu().numpy()


def step(device: Device, env, params, state, action, next_state, rng):
    """Advance the dynamics; returns the per-env dts.

    Maintains the observation history rings exactly like `quad.step` (shift,
    append newest)."""
    n = env.N_ENVIRONMENTS
    # clip BEFORE integrating and recording, exactly like quad.step: the
    # history ring must hold the executed (clipped) action
    a = torch.clamp(torch.as_tensor(np.asarray(action, np.float32), device=device.device),
                    -1.0, 1.0)
    nxt, dt = env.impl.dynamics_step(params.stacked, state.dynamics, a, rng.generator(device))
    next_state.dynamics = nxt
    next_state.action_history = torch.cat([state.action_history[:, 1:], a[:, None]], 1)
    next_state.angvel_history = torch.cat(
        [state.angvel_history[:, 1:], nxt.angular_velocity[:, None]], 1)
    return np.full(n, dt, np.float32)


# -- UI message builders (the reference README's naming) ---------------------


class UI:
    """UI handle: carries the namespace from the ui-server handshake."""

    def __init__(self, namespace: str = "default"):
        self.ns = namespace


def set_ui_message(device: Device, env, ui: "UI", model_url=None) -> str:
    """The JSON ui_message payload (to send over the websocket)."""
    return json.dumps(ui_mod.ui_message(ui.ns, model_url))


def set_parameters_message(device: Device, env, params, ui: "UI") -> str:
    return json.dumps(ui_mod.parameters_message(ui.ns, params.stacked, env.N_ENVIRONMENTS))


def set_state_action_message(device: Device, env, params, ui: "UI", state, action) -> str:
    return json.dumps(ui_mod.state_action_message(ui.ns, state.dynamics, np.asarray(action)))
