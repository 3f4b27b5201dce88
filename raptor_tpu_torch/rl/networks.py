"""The networks of the SAC teachers: an MLP actor with a squashed-Gaussian
(mu, log_std) head and twin Q critics.

Counterpart of `raptor_tpu/rl/networks.py`. Parameters are a plain dict
`{"layers": [{"w": [in, out], "b": [out]}, ...]}`; layers compute `x @ w + b`
in f32, or with `dtype=torch.bfloat16` through `matmul_lp` (operands rounded
to bf16, f32 accumulation and output). A population of K networks is the same
dict with a leading [K] axis on every tensor (`stack_actors`, or the `n_stack`
argument of the `*_init` functions), applied to inputs [K, B, in] as one
batched matmul per layer, the counterpart of `jax.vmap` over the members.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

Params = Dict[str, Any]

LOG_STD_MIN = -10.0
LOG_STD_MAX = 2.0


class _MatmulLP(torch.autograd.Function):
    """x @ w with both operands rounded to `dtype`, accumulated and returned
    in f32; the two backward products round their operands the same way."""

    @staticmethod
    def forward(ctx, x, w, dtype):
        xd, wd = x.to(dtype), w.to(dtype)
        ctx.save_for_backward(xd, wd)
        ctx.lp_dtype = dtype
        return torch.matmul(xd.float(), wd.float())

    @staticmethod
    def backward(ctx, g):
        xd, wd = ctx.saved_tensors
        gd = g.to(ctx.lp_dtype).float()
        dx = torch.matmul(gd, wd.float().transpose(-1, -2))
        dw = torch.matmul(xd.float().transpose(-1, -2), gd)
        return dx, dw, None


def matmul_lp(dtype, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w with both operands cast to `dtype` (bf16) and f32 accumulation
    and output. Differentiable; the backward matmuls round their operands to
    `dtype` too. x: [..., B, I], w: [..., I, O] with identical leading dims.

    The rounded operands are multiplied as f32 (`torch.matmul` on bf16
    tensors would round the output to bf16): a product of two bf16 values is
    exact in f32, so this is bf16 operands with f32 accumulation on every
    device. It does not use the bf16 tensor cores."""
    return _MatmulLP.apply(x, w, dtype)


def _dot(x: torch.Tensor, w: torch.Tensor, dtype) -> torch.Tensor:
    return torch.matmul(x, w) if dtype is None else matmul_lp(dtype, x, w)


def _dense_init(generator: torch.Generator, in_dim: int, out_dim: int, scale: float = 1.0,
                lead: Tuple[int, ...] = ()):
    bound = scale / math.sqrt(in_dim)
    u = torch.rand((*lead, in_dim, out_dim), generator=generator, device=generator.device)
    return {
        "w": -bound + u * (2.0 * bound),
        "b": torch.zeros((*lead, out_dim), device=generator.device),
    }


def mlp_init(generator: torch.Generator, dims: Sequence[int], final_scale: float = 1.0,
             n_stack: Optional[int] = None) -> Params:
    """Uniform +-scale/sqrt(fan_in) weights and zero biases on the
    generator's device; `final_scale` applies to the last layer. With
    `n_stack` = K every tensor gets a leading [K] axis: K independent MLPs."""
    last = len(dims) - 2
    lead = () if n_stack is None else (n_stack,)
    return {
        "layers": [
            _dense_init(generator, dims[i], dims[i + 1], final_scale if i == last else 1.0, lead)
            for i in range(len(dims) - 1)
        ]
    }


def _dense(layer, x: torch.Tensor, dtype=None) -> torch.Tensor:
    w, b = layer["w"], layer["b"]
    return _dot(x, w, dtype) + (b if w.dim() == 2 else b.unsqueeze(-2))


def mlp_apply(params: Params, x: torch.Tensor, activation=torch.relu, dtype=None) -> torch.Tensor:
    """x [..., in] through one MLP, or x [K, B, in] through K stacked MLPs.
    dtype=None: f32 throughout. dtype=torch.bfloat16: the matmuls go through
    `matmul_lp`."""
    layers = params["layers"]
    for layer in layers[:-1]:
        x = activation(_dense(layer, x, dtype))
    return _dense(layers[-1], x, dtype)


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


def standardize_init(dim: int, device) -> Params:
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
# actor: obs -> (mu, log_std); sample-and-squash head
# ---------------------------------------------------------------------------


def actor_init(
    generator: torch.Generator, obs_dim: int, action_dim: int, hidden: Sequence[int] = (64, 64),
    n_stack: Optional[int] = None,
) -> Params:
    return mlp_init(generator, [obs_dim, *hidden, 2 * action_dim], final_scale=0.01,
                    n_stack=n_stack)


def actor_dist(params: Params, obs: torch.Tensor, dtype=None) -> Tuple[torch.Tensor, torch.Tensor]:
    mu, log_std = mlp_apply(params, obs, dtype=dtype).chunk(2, -1)
    return mu, torch.clamp(log_std, LOG_STD_MIN, LOG_STD_MAX)


def sample_and_squash(
    mu: torch.Tensor, log_std: torch.Tensor, generator: Optional[torch.Generator] = None,
    eps: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sample a ~ tanh(N(mu, sigma)); returns (action, log_prob [...]) with the
    tanh change-of-variables correction summed over the action dimensions.
    The standard-normal noise `eps` (shape of `mu`) is drawn from `generator`
    unless handed in."""
    if eps is None:
        eps = torch.randn(mu.shape, generator=generator, device=mu.device, dtype=mu.dtype)
    pre = mu + torch.exp(log_std) * eps
    action = torch.tanh(pre)
    log_prob = torch.sum(-0.5 * eps**2 - log_std - 0.5 * math.log(2.0 * math.pi), -1)
    # log(1 - tanh(x)^2) in its stable form 2 (log 2 - x - softplus(-2x))
    log_prob = log_prob - torch.sum(
        2.0 * (math.log(2.0) - pre - torch.nn.functional.softplus(-2.0 * pre)), -1
    )
    return action, log_prob


def actor_sample(params: Params, obs: torch.Tensor, generator: Optional[torch.Generator] = None,
                 dtype=None, eps: Optional[torch.Tensor] = None):
    mu, log_std = actor_dist(params, obs, dtype=dtype)
    return sample_and_squash(mu, log_std, generator, eps)


def actor_mean(params: Params, obs: torch.Tensor) -> torch.Tensor:
    """Deterministic (eval) action."""
    return torch.tanh(actor_dist(params, obs)[0])


# ---------------------------------------------------------------------------
# twin critics: (obs, action) -> q
# ---------------------------------------------------------------------------


def critic_init(
    generator: torch.Generator, obs_dim: int, action_dim: int, hidden: Sequence[int] = (64, 64),
    n_stack: Optional[int] = None,
) -> Params:
    dims = [obs_dim + action_dim, *hidden, 1]
    return {"q1": mlp_init(generator, dims, n_stack=n_stack),
            "q2": mlp_init(generator, dims, n_stack=n_stack)}


def critic_apply(params: Params, obs: torch.Tensor, action: torch.Tensor, dtype=None,
                 stacked: bool = False):
    """Twin Q values (q1, q2), each [...]. stacked=True runs q1 and q2 as one
    batched matmul per layer ([2, ..., B, I] @ [2, ..., I, O]): the same
    numbers from half the launches."""
    x = torch.cat([obs, action], -1)
    if not stacked:
        q1 = mlp_apply(params["q1"], x, dtype=dtype)[..., 0]
        q2 = mlp_apply(params["q2"], x, dtype=dtype)[..., 0]
        return q1, q2
    l1, l2 = params["q1"]["layers"], params["q2"]["layers"]
    h = x.expand(2, *x.shape)
    n_layers = len(l1)
    for i in range(n_layers):
        w = torch.stack([l1[i]["w"], l2[i]["w"]])
        b = torch.stack([l1[i]["b"], l2[i]["b"]]).unsqueeze(-2)
        h = _dot(h, w, dtype) + b
        if i < n_layers - 1:
            h = torch.relu(h)
    return h[0, ..., 0], h[1, ..., 0]


def tree_clone(params):
    """A copy of a parameter tree (nested dicts and lists) that shares no
    storage with it and records no gradient."""
    if isinstance(params, torch.Tensor):
        return params.detach().clone()
    if isinstance(params, dict):
        return {k: tree_clone(v) for k, v in params.items()}
    return [tree_clone(v) for v in params]


@torch.no_grad()
def polyak_(target, source, tau: float) -> None:
    """target <- (1 - tau) target + tau source, leaf by leaf, in place."""
    leaves = tree_leaves(target)
    torch._foreach_mul_(leaves, 1.0 - tau)
    torch._foreach_add_(leaves, tree_leaves(source), alpha=tau)


def tree_leaves(params) -> list:
    """The tensors of a parameter tree (nested dicts and lists), in a fixed
    order."""
    if isinstance(params, torch.Tensor):
        return [params]
    items = params.values() if isinstance(params, dict) else params
    return [leaf for item in items for leaf in tree_leaves(item)]
