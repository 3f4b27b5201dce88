"""PPO: clipped-surrogate on-policy training with GAE.

Counterpart of `raptor_tpu/rl/ppo.py`: `ppo_rollout` runs H steps of N envs
and computes GAE, `ppo_update` runs epochs of minibatches. Two details follow
the JAX package's arithmetic rather than PyTorch's defaults:

- the advantages are normalised by their population std (ddof 0, as
  `jnp.std`), not `torch.std`'s ddof 1;
- one Adam runs over the tree {actor, value} behind `optax.clip_by_global_norm`:
  the norm spans both networks, and where it exceeds `max_grad_norm` every
  gradient becomes (g / norm) * max_grad_norm
  (`torch.nn.utils.clip_grad_norm_` divides by norm + 1e-6 instead).

`PPOState` is a mutable dataclass updated in place.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Tuple

import torch

from raptor_tpu_torch.env.quad import L2F, EnvState
from raptor_tpu_torch.env.types import DynamicsParams
from raptor_tpu_torch.rl import networks
from raptor_tpu_torch.rl.sac import adam


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    entropy_coef: float = 0.01
    value_coef: float = 0.5
    learning_rate: float = 3e-4
    max_grad_norm: float = 0.5
    n_epochs: int = 4
    n_minibatches: int = 4
    actor_hidden: Tuple[int, ...] = (64, 64)
    value_hidden: Tuple[int, ...] = (64, 64)
    rollout_length: int = 64


@dataclasses.dataclass
class PPOState:
    actor: dict  # Gaussian actor (mu, log_std heads); tanh at execution
    value: dict
    opt: torch.optim.Adam  # over the leaves of actor, then value
    step: int


class PPOMetrics(NamedTuple):
    policy_loss: torch.Tensor
    value_loss: torch.Tensor
    entropy: torch.Tensor
    approx_kl: torch.Tensor


def make_state(actor, value, config: PPOConfig, step: int = 0) -> PPOState:
    """A `PPOState` around given networks, with a fresh Adam over the leaves
    of {"actor", "value"}."""
    leaves = networks.tree_leaves({"actor": actor, "value": value})
    for leaf in leaves:
        leaf.requires_grad_(True)
    return PPOState(actor=actor, value=value, opt=adam(leaves, config.learning_rate), step=step)


def ppo_init(generator: torch.Generator, obs_dim: int, action_dim: int,
             config: PPOConfig = PPOConfig()) -> PPOState:
    actor = networks.actor_init(generator, obs_dim, action_dim, config.actor_hidden)
    value = networks.mlp_init(generator, [obs_dim, *config.value_hidden, 1])
    return make_state(actor, value, config)


def _gaussian_logp(mu, log_std, action):
    std = torch.exp(log_std)
    return torch.sum(
        -0.5 * ((action - mu) / std) ** 2 - log_std - 0.5 * math.log(2 * math.pi), -1)


def gae(value, reward, done, terminated, v_next, config: PPOConfig) -> torch.Tensor:
    """Advantages [H, N] by a reverse pass. Bootstrapping uses V(final_obs)
    and is cut only by true termination (a truncated episode still
    bootstraps); the accumulator is cut at every episode boundary."""
    adv = torch.zeros_like(value)
    acc = torch.zeros_like(value[0])
    for t in reversed(range(value.shape[0])):
        delta = reward[t] + config.gamma * v_next[t] * (1 - terminated[t]) - value[t]
        acc = delta + config.gamma * config.gae_lambda * (1 - done[t]) * acc
        adv[t] = acc
    return adv


@torch.no_grad()
def ppo_rollout(
    state: PPOState,
    env: L2F,
    params: DynamicsParams,
    env_state: EnvState,
    obs: torch.Tensor,
    generator: torch.Generator,
    config: PPOConfig,
    noise: Optional[torch.Tensor] = None,
):
    """H on-policy steps; returns (env_state, obs, batch dict of [H, N, ...]).
    Actions are pre-tanh Gaussian samples (log-prob in that space), executed
    tanh-squashed. `noise` [H, N, act] replaces the generator's draws."""
    rows = []
    for t in range(config.rollout_length):
        mu, log_std = networks.actor_dist(state.actor, obs)
        eps = noise[t] if noise is not None else torch.randn(
            mu.shape, generator=generator, device=mu.device)
        raw = mu + torch.exp(log_std) * eps
        logp = _gaussian_logp(mu, log_std, raw)
        value = networks.mlp_apply(state.value, obs)[..., 0]
        env_state, next_obs, reward, done, info = env.step(
            params, env_state, torch.tanh(raw), generator)
        # the bootstrap value of the true (pre-reset) successor state
        v_next = networks.mlp_apply(state.value, info["final_obs"])[..., 0]
        rows.append((obs, raw, logp, value, reward, done.float(),
                     info["terminated"].float(), v_next))
        obs = next_obs
    o, raw, logp, value, reward, done, terminated, v_next = (
        torch.stack([row[i] for row in rows]) for i in range(8))
    advantages = gae(value, reward, done, terminated, v_next, config)
    batch = {"obs": o, "raw_action": raw, "logp": logp, "advantage": advantages,
             "return": advantages + value}
    return env_state, obs, batch


def _loss(state: PPOState, mb: dict, config: PPOConfig):
    mu, log_std = networks.actor_dist(state.actor, mb["obs"])
    logp = _gaussian_logp(mu, log_std, mb["raw_action"])
    ratio = torch.exp(logp - mb["logp"])
    clipped = torch.clamp(ratio, 1 - config.clip_eps, 1 + config.clip_eps)
    policy_loss = -torch.mean(torch.minimum(ratio * mb["advantage"], clipped * mb["advantage"]))
    value = networks.mlp_apply(state.value, mb["obs"])[..., 0]
    value_loss = torch.mean((value - mb["return"]) ** 2)
    entropy = torch.mean(torch.sum(log_std + 0.5 * math.log(2 * math.pi * math.e), -1))
    total = policy_loss + config.value_coef * value_loss - config.entropy_coef * entropy
    approx_kl = torch.mean(mb["logp"] - logp)
    return total, PPOMetrics(policy_loss.detach(), value_loss.detach(), entropy.detach(),
                             approx_kl.detach())


def _clipped_step(opt: torch.optim.Adam, loss: torch.Tensor, max_norm: float) -> None:
    """One Adam step on the gradient of `loss`, clipped as
    `optax.clip_by_global_norm`: (g / norm) * max_norm where norm >= max_norm."""
    leaves = [p for group in opt.param_groups for p in group["params"]]
    grads = torch.autograd.grad(loss, leaves)
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = norm < max_norm
    for p, g in zip(leaves, grads):
        p.grad = torch.where(keep, g, g / norm * max_norm)
    opt.step()
    opt.zero_grad(set_to_none=True)


def ppo_update(
    state: PPOState,
    generator: Optional[torch.Generator],
    batch: dict,
    config: PPOConfig = PPOConfig(),
    perms: Optional[torch.Tensor] = None,
) -> Tuple[PPOState, PPOMetrics]:
    """Epochs x minibatches of clipped-surrogate updates on the flattened
    rollout. `perms` [n_epochs, n] (a permutation of the n samples an epoch)
    replaces the generator's draws. Returns the last minibatch's metrics of
    the last epoch. Updates `state` in place."""
    flat = {k: v.reshape(-1, *v.shape[2:]) for k, v in batch.items()}
    n = flat["logp"].shape[0]
    mb_size = n // config.n_minibatches
    adv = flat["advantage"]
    flat["advantage"] = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    metrics = None
    for e in range(config.n_epochs):
        perm = perms[e] if perms is not None else torch.randperm(
            n, generator=generator, device=adv.device)
        perm = perm[: mb_size * config.n_minibatches].reshape(config.n_minibatches, mb_size)
        for idx in perm:
            total, metrics = _loss(state, {k: v[idx] for k, v in flat.items()}, config)
            _clipped_step(state.opt, total, config.max_grad_norm)
    state.step += 1
    return state, metrics


def make_ppo_iteration(env: L2F, config: PPOConfig):
    """(state, params, env_state, obs, generator) -> (state, env_state, obs,
    generator, metrics): one rollout and one update."""

    def iteration(state, params, env_state, obs, generator):
        env_state, obs, batch = ppo_rollout(
            state, env, params, env_state, obs, generator, config)
        state, metrics = ppo_update(state, generator, batch, config)
        return state, env_state, obs, generator, metrics

    return iteration
