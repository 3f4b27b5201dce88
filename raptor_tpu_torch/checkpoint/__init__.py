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
    return mlp_from_numpy(actors_np, device), dynamics_params_from_numpy(airframes_np, device)


def mlp_from_numpy(mlp_np, device) -> dict:
    """An MLP {"layers": [{"w", "b"}, ...]} given as arrays, single or with a
    leading [K] axis, -> the same dict of f32 tensors on `device`."""
    return {
        "layers": [
            {k: _tensor(layer[k], device) for k in ("w", "b")} for layer in mlp_np["layers"]
        ]
    }


def critic_from_numpy(critic_np, device) -> dict:
    """Twin critics {"q1": mlp, "q2": mlp} given as arrays -> tensors on
    `device`."""
    return {q: mlp_from_numpy(critic_np[q], device) for q in ("q1", "q2")}


def _load_adam(opt: torch.optim.Adam, adam_np, to_tree) -> None:
    """Fill a fresh `torch.optim.Adam` from an `optax.adam` state given as
    arrays: `adam_np[0]` carries `count`, `mu` and `nu`, the moments in the
    parameters' tree structure (`to_tree` converts one of them)."""
    from raptor_tpu_torch.rl.networks import tree_leaves

    scale = adam_np[0]
    count = float(np.max(np.asarray(scale.count)))
    leaves = [p for group in opt.param_groups for p in group["params"]]
    mus, nus = tree_leaves(to_tree(scale.mu)), tree_leaves(to_tree(scale.nu))
    for p, mu, nu in zip(leaves, mus, nus):
        opt.state[p] = {"step": torch.tensor(count), "exp_avg": mu, "exp_avg_sq": nu}


def sac_state_from_numpy(state_np, device, config=None):
    """A SAC learner given as arrays (the JAX package's `SACState` with every
    leaf a numpy array: actor, twin critics, target critics, `log_alpha`, the
    three `optax.adam` states' `mu`/`nu`/`count`, `step`), single or stacked
    [K], -> `rl.sac.SACState` on `device` with its optimizers at the same
    moments and count."""
    from raptor_tpu_torch.rl import sac

    config = sac.SACConfig() if config is None else config
    state = sac.make_state(
        mlp_from_numpy(state_np.actor, device),
        critic_from_numpy(state_np.critic, device),
        critic_from_numpy(state_np.target_critic, device),
        _tensor(state_np.log_alpha, device),
        config,
        step=int(np.max(np.asarray(state_np.step))),
    )
    _load_adam(state.actor_opt, state_np.actor_opt, lambda t: mlp_from_numpy(t, device))
    _load_adam(state.critic_opt, state_np.critic_opt, lambda t: critic_from_numpy(t, device))
    _load_adam(state.alpha_opt, state_np.alpha_opt, lambda t: _tensor(t, device))
    return state


def transition_buffer_from_numpy(buf_np, device):
    """A replay ring given as arrays (the JAX package's `TransitionBuffer`,
    [C, N, d] or stacked [K, C, N, d]) -> `rl.replay.TransitionBuffer` on
    `device`; `ptr` and `size` become ints (the members of a stacked ring
    advance in lockstep)."""
    from raptor_tpu_torch.rl.replay import TransitionBuffer

    return TransitionBuffer(
        obs=_tensor(buf_np.obs, device),
        action=_tensor(buf_np.action, device),
        reward=_tensor(buf_np.reward, device),
        next_obs=_tensor(buf_np.next_obs, device),
        done=_tensor(buf_np.done, device),
        ptr=int(np.max(np.asarray(buf_np.ptr))),
        size=int(np.max(np.asarray(buf_np.size))),
    )


def sac_gru_state_from_numpy(state_np, device, config=None):
    """A recurrent SAC learner given as arrays (the JAX package's
    `SACGRUState` with every leaf a numpy array: actor, twin critics and
    their targets, `log_alpha`, the three `optax.adam` states, `step`) ->
    `rl.sac_gru.SACGRUState` on `device`. The JAX package runs one Adam over
    the pair of critics; its moments split over the port's Adam in the same
    order, under the one shared count."""
    from raptor_tpu_torch.rl import sac_gru

    config = sac_gru.SACGRUConfig() if config is None else config
    gru = lambda t: from_numpy(t, device)  # noqa: E731
    state = sac_gru.make_state(
        gru(state_np.actor), gru(state_np.critic1), gru(state_np.critic2),
        gru(state_np.target1), gru(state_np.target2), _tensor(state_np.log_alpha, device),
        config, step=int(np.asarray(state_np.step)),
    )
    _load_adam(state.actor_opt, state_np.actor_opt, gru)
    _load_adam(state.critic_opt, state_np.critic_opt, lambda t: (gru(t[0]), gru(t[1])))
    _load_adam(state.alpha_opt, state_np.alpha_opt, lambda t: _tensor(t, device))
    return state


def td3_state_from_numpy(state_np, device, config=None):
    """A TD3 learner given as arrays (the JAX package's `TD3State`: actor,
    target actor, twin critics, target critics, two `optax.adam` states,
    `step`) -> `rl.td3.TD3State` on `device`. The actor's Adam count is the
    number of policy steps taken, as in the JAX state."""
    from raptor_tpu_torch.rl import td3

    config = td3.TD3Config() if config is None else config
    state = td3.make_state(
        mlp_from_numpy(state_np.actor, device), mlp_from_numpy(state_np.target_actor, device),
        critic_from_numpy(state_np.critic, device),
        critic_from_numpy(state_np.target_critic, device),
        config, step=int(np.asarray(state_np.step)),
    )
    _load_adam(state.actor_opt, state_np.actor_opt, lambda t: mlp_from_numpy(t, device))
    _load_adam(state.critic_opt, state_np.critic_opt, lambda t: critic_from_numpy(t, device))
    return state


def ppo_state_from_numpy(state_np, device, config=None):
    """A PPO learner given as arrays (the JAX package's `PPOState`: actor,
    value, the `optax.chain(clip_by_global_norm, adam)` state over
    {actor, value}, `step`) -> `rl.ppo.PPOState` on `device`."""
    from raptor_tpu_torch.rl import ppo

    config = ppo.PPOConfig() if config is None else config
    state = ppo.make_state(mlp_from_numpy(state_np.actor, device),
                           mlp_from_numpy(state_np.value, device), config,
                           step=int(np.asarray(state_np.step)))
    _load_adam(state.opt, state_np.opt[1], lambda t: {
        "actor": mlp_from_numpy(t["actor"], device), "value": mlp_from_numpy(t["value"], device)})
    return state


def sequence_buffer_from_numpy(buf_np, device):
    """A sequence ring given as arrays (the JAX package's `SequenceBuffer`,
    [C, N, d]) -> `rl.replay.SequenceBuffer` on `device`; `ptr` and `size`
    become ints."""
    from raptor_tpu_torch.rl.replay import SequenceBuffer

    return SequenceBuffer(
        obs=_tensor(buf_np.obs, device),
        action=_tensor(buf_np.action, device),
        reward=_tensor(buf_np.reward, device),
        done=_tensor(buf_np.done, device),
        reset=_tensor(buf_np.reset, device),
        ptr=int(np.asarray(buf_np.ptr)),
        size=int(np.asarray(buf_np.size)),
    )
