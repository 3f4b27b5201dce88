"""The Raptor foundation-policy network: Dense(22->16, ReLU) -> GRU(16) ->
Dense(16->4, identity), 2,084 f32 parameters.

Counterpart of `raptor_tpu/policy/network.py`. The GRU uses the PyTorch gate
convention with gate order (r, z, n), the reset gate applied to the hidden
pre-activation after matmul + bias, and a learned initial hidden state.
Parameters are a plain nested dict of tensors under the JAX package's key
names (`dense_0`, `gru_1`, `dense_2`).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

OBS_DIM = 22
ACTION_DIM = 4
HIDDEN_DIM = 16

Params = Dict[str, Dict[str, torch.Tensor]]


def init_params(
    generator: torch.Generator,
    obs_dim: int = OBS_DIM,
    hidden_dim: int = HIDDEN_DIM,
    action_dim: int = ACTION_DIM,
    dtype=torch.float32,
) -> Params:
    """Fresh parameters (uniform +-1/sqrt(fan_in) weights, zero biases and h0)
    on the generator's device."""
    dev = generator.device

    def uniform(shape, fan_in):
        bound = 1.0 / math.sqrt(fan_in)
        u = torch.rand(shape, generator=generator, device=dev, dtype=dtype)
        return -bound + u * (2.0 * bound)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return {
        "dense_0": {
            "weights": uniform((hidden_dim, obs_dim), obs_dim),
            "biases": zeros(hidden_dim),
        },
        "gru_1": {
            "weights_input": uniform((3 * hidden_dim, hidden_dim), hidden_dim),
            "weights_hidden": uniform((3 * hidden_dim, hidden_dim), hidden_dim),
            "biases_input": zeros(3 * hidden_dim),
            "biases_hidden": zeros(3 * hidden_dim),
            "initial_hidden_state": zeros(hidden_dim),
        },
        "dense_2": {
            "weights": uniform((action_dim, hidden_dim), hidden_dim),
            "biases": zeros(action_dim),
        },
    }


def initial_hidden(params: Params, batch_size: int) -> torch.Tensor:
    """Learned initial hidden state broadcast to [B, H]."""
    h0 = params["gru_1"]["initial_hidden_state"]
    return h0.expand(batch_size, h0.shape[-1]).contiguous()


def gru_cell(params: Params, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """One GRU step (PyTorch convention, gates r, z, n): h [B, H], x [B, H]."""
    g = params["gru_1"]
    n_h = h.shape[-1]
    gi = x @ g["weights_input"].T + g["biases_input"]
    gh = h @ g["weights_hidden"].T + g["biases_hidden"]
    r = torch.sigmoid(gi[..., :n_h] + gh[..., :n_h])
    z = torch.sigmoid(gi[..., n_h : 2 * n_h] + gh[..., n_h : 2 * n_h])
    n = torch.tanh(gi[..., 2 * n_h :] + r * gh[..., 2 * n_h :])
    return (1.0 - z) * n + z * h


def apply_step(
    params: Params, h: torch.Tensor, obs: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """obs [B, 22] + hidden [B, 16] -> (new hidden, action [B, 4]). The head is
    identity: callers clip to [-1, 1]."""
    d0, d2 = params["dense_0"], params["dense_2"]
    x = torch.relu(obs @ d0["weights"].T + d0["biases"])
    h_new = gru_cell(params, h, x)
    return h_new, h_new @ d2["weights"].T + d2["biases"]


def apply_sequence(
    params: Params, obs_seq: torch.Tensor, h0: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """obs_seq [T, B, 22] -> (final hidden [B, 16], actions [T, B, 4])."""
    h = initial_hidden(params, obs_seq.shape[1]) if h0 is None else h0
    actions = []
    for obs_t in obs_seq:
        h, a = apply_step(params, h, obs_t)
        actions.append(a)
    return h, torch.stack(actions)


def fold_norm(params: Params, mean: torch.Tensor, std: torch.Tensor) -> Params:
    """Fold an observation standardizer (obs - mean) / std into dense_0:
    W ((x - mean)/std) + b == (W/std) x + (b - (W/std) mean)."""
    d0 = params["dense_0"]
    w = d0["weights"] / std[None, :]
    b = d0["biases"] - w @ mean
    return {**params, "dense_0": {"weights": w, "biases": b}}


def num_params(params: Dict[str, Any]) -> int:
    return sum(t.numel() for layer in params.values() for t in layer.values())
