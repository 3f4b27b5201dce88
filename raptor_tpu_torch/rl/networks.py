"""The feedforward actor of the SAC teachers: an MLP with a (mu, log_std)
head, applied deterministically (tanh of the mean) as a DAgger label.

Counterpart of the actor half of `raptor_tpu/rl/networks.py`. Parameters are
a plain dict `{"layers": [{"w": [in, out], "b": [out]}, ...]}`; layers compute
`x @ w + b` in f32. A population of K actors is the same dict with a leading
[K] axis on every tensor (`stack_actors`), applied to inputs [K, B, in] as one
batched matmul per layer, the counterpart of `jax.vmap(actor_mean)`.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Sequence, Tuple

import torch

Params = Dict[str, Any]

LOG_STD_MIN = -10.0
LOG_STD_MAX = 2.0


def _dense_init(generator: torch.Generator, in_dim: int, out_dim: int, scale: float = 1.0):
    bound = scale / math.sqrt(in_dim)
    u = torch.rand((in_dim, out_dim), generator=generator, device=generator.device)
    return {
        "w": -bound + u * (2.0 * bound),
        "b": torch.zeros(out_dim, device=generator.device),
    }


def mlp_init(generator: torch.Generator, dims: Sequence[int], final_scale: float = 1.0) -> Params:
    """Uniform +-scale/sqrt(fan_in) weights and zero biases on the
    generator's device; `final_scale` applies to the last layer."""
    last = len(dims) - 2
    return {
        "layers": [
            _dense_init(generator, dims[i], dims[i + 1], final_scale if i == last else 1.0)
            for i in range(len(dims) - 1)
        ]
    }


def _dense(layer, x: torch.Tensor) -> torch.Tensor:
    w, b = layer["w"], layer["b"]
    return torch.matmul(x, w) + (b if w.dim() == 2 else b.unsqueeze(-2))


def mlp_apply(params: Params, x: torch.Tensor, activation=torch.relu) -> torch.Tensor:
    """x [..., in] through one MLP, or x [K, B, in] through K stacked MLPs."""
    layers = params["layers"]
    for layer in layers[:-1]:
        x = activation(_dense(layer, x))
    return _dense(layers[-1], x)


def stack_actors(actors: Sequence[Params]) -> Params:
    """K parameter dicts -> one dict with a leading [K] axis on every tensor."""
    return {
        "layers": [
            {k: torch.stack([a["layers"][i][k] for a in actors]) for k in ("w", "b")}
            for i in range(len(actors[0]["layers"]))
        ]
    }


def take_actors(actors: Params, idx: torch.Tensor) -> Params:
    """The actors at positions `idx` of a stacked population."""
    return {"layers": [{k: v[idx] for k, v in layer.items()} for layer in actors["layers"]]}


def n_actors(actors: Params) -> int:
    return actors["layers"][0]["w"].shape[0]


# ---------------------------------------------------------------------------
# standardize layer: input normalization that folds into a following dense
# ---------------------------------------------------------------------------


def standardize_init(dim: int, device="cpu") -> Params:
    return {"mean": torch.zeros(dim, device=device), "std": torch.ones(dim, device=device)}


def standardize_apply(params: Params, x: torch.Tensor) -> torch.Tensor:
    return (x - params["mean"]) / params["std"]


def standardize_from_batch(x: torch.Tensor, eps: float = 1e-6) -> Params:
    """Fit mean and (population) std over the leading axes of a data batch."""
    flat = x.reshape(-1, x.shape[-1])
    return {"mean": flat.mean(0), "std": flat.std(0, correction=0) + eps}


def fold_standardize_into_dense(std_params: Params, dense: Params) -> Params:
    """Fold (x - mean) / std into a following dense layer {w: [in, out],
    b: [out]}, so the deployed network needs no separate standardize op."""
    w, b = dense["w"], dense["b"]
    return {
        "w": w / std_params["std"][:, None],
        "b": b - (std_params["mean"] / std_params["std"]) @ w,
    }


# ---------------------------------------------------------------------------
# actor: obs -> (mu, log_std); deterministic action tanh(mu)
# ---------------------------------------------------------------------------


def actor_init(
    generator: torch.Generator, obs_dim: int, action_dim: int, hidden: Sequence[int] = (64, 64)
) -> Params:
    return mlp_init(generator, [obs_dim, *hidden, 2 * action_dim], final_scale=0.01)


def actor_dist(params: Params, obs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    mu, log_std = mlp_apply(params, obs).chunk(2, -1)
    return mu, torch.clamp(log_std, LOG_STD_MIN, LOG_STD_MAX)


def actor_mean(params: Params, obs: torch.Tensor) -> torch.Tensor:
    """Deterministic (eval) action."""
    return torch.tanh(actor_dist(params, obs)[0])
