"""TD3: twin-delayed deterministic policy gradient.

Counterpart of `raptor_tpu/rl/td3.py`: a deterministic tanh MLP actor, twin Q
critics (`rl.networks`), target networks, and an actor and targets updated on
every `policy_delay`-th step only. Takes the `TransitionBuffer` minibatch
tuple, as `rl.sac` does. `TD3State` is a mutable dataclass updated in place.

The JAX package computes the delayed update on every step and selects it
(`jnp.where`) on policy steps. Here the actor's Adam steps, and the targets
move, on policy steps only: the same result, with the actor, its Adam moments
and count, the target actor and the target critic left as they were on the
other steps. The actor loss is computed and reported on every step.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from raptor_tpu_torch.rl import networks
from raptor_tpu_torch.rl.sac import _step, adam


@dataclasses.dataclass(frozen=True)
class TD3Config:
    gamma: float = 0.99
    tau: float = 0.005
    actor_lr: float = 3e-4
    critic_lr: float = 3e-4
    policy_delay: int = 2
    target_noise_std: float = 0.2
    target_noise_clip: float = 0.5
    exploration_noise_std: float = 0.1
    actor_hidden: Tuple[int, ...] = (64, 64)
    critic_hidden: Tuple[int, ...] = (64, 64)


@dataclasses.dataclass
class TD3State:
    actor: dict
    target_actor: dict
    critic: dict
    target_critic: dict
    actor_opt: torch.optim.Adam
    critic_opt: torch.optim.Adam
    step: int


class TD3Metrics(NamedTuple):
    critic_loss: torch.Tensor
    actor_loss: torch.Tensor
    q1_mean: torch.Tensor


def deterministic_actor_init(generator: torch.Generator, obs_dim: int, action_dim: int,
                             hidden: Sequence[int]):
    return networks.mlp_init(generator, [obs_dim, *hidden, action_dim], final_scale=0.01)


def deterministic_actor_apply(params, obs: torch.Tensor) -> torch.Tensor:
    return torch.tanh(networks.mlp_apply(params, obs))


def make_state(actor, target_actor, critic, target_critic, config: TD3Config,
               step: int = 0) -> TD3State:
    """A `TD3State` around given parameter trees, with fresh Adams. The actor
    and critic become leaves that record gradients."""
    for leaf in networks.tree_leaves((actor, critic)):
        leaf.requires_grad_(True)
    return TD3State(
        actor=actor, target_actor=target_actor, critic=critic, target_critic=target_critic,
        actor_opt=adam(networks.tree_leaves(actor), config.actor_lr),
        critic_opt=adam(networks.tree_leaves(critic), config.critic_lr),
        step=step,
    )


def td3_init(generator: torch.Generator, obs_dim: int, action_dim: int,
             config: TD3Config = TD3Config()) -> TD3State:
    """A fresh learner on the generator's device."""
    actor = deterministic_actor_init(generator, obs_dim, action_dim, config.actor_hidden)
    critic = networks.critic_init(generator, obs_dim, action_dim, config.critic_hidden)
    return make_state(actor, networks.tree_clone(actor), critic, networks.tree_clone(critic),
                      config)


def td3_update(
    state: TD3State,
    generator: Optional[torch.Generator],
    batch: Tuple[torch.Tensor, ...],  # (obs, action, reward, next_obs, done)
    config: TD3Config = TD3Config(),
    noise: Optional[torch.Tensor] = None,
) -> Tuple[TD3State, TD3Metrics]:
    """One TD3 step on a minibatch [B, d]. Updates `state` in place.

    `noise` (standard normal, the actions' shape) replaces the generator's
    draw for the target policy smoothing noise, N(0, target_noise_std)
    clipped to +-target_noise_clip."""
    obs, action, reward, next_obs, done = batch

    # ---- critic ----
    with torch.no_grad():
        if noise is None:
            noise = torch.randn(action.shape, generator=generator, device=action.device)
        smooth = torch.clamp(noise * config.target_noise_std,
                             -config.target_noise_clip, config.target_noise_clip)
        next_action = torch.clamp(
            deterministic_actor_apply(state.target_actor, next_obs) + smooth, -1.0, 1.0)
        tq1, tq2 = networks.critic_apply(state.target_critic, next_obs, next_action)
        target_q = reward + config.gamma * (1.0 - done) * torch.minimum(tq1, tq2)
    q1, q2 = networks.critic_apply(state.critic, obs, action)
    critic_loss = torch.mean((q1 - target_q) ** 2) + torch.mean((q2 - target_q) ** 2)
    _step(state.critic_opt, critic_loss)

    # ---- delayed actor and target updates ----
    do_policy = state.step % config.policy_delay == 0
    with torch.set_grad_enabled(do_policy):
        pq1, _ = networks.critic_apply(state.critic, obs,
                                       deterministic_actor_apply(state.actor, obs))
        actor_loss = -torch.mean(pq1)
    if do_policy:
        _step(state.actor_opt, actor_loss)
        networks.polyak_((state.target_actor, state.target_critic), (state.actor, state.critic),
                         config.tau)

    state.step += 1
    return state, TD3Metrics(critic_loss=critic_loss.detach(), actor_loss=actor_loss.detach(),
                             q1_mean=q1.detach().mean())
