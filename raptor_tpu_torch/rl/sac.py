"""Soft Actor-Critic learner: twin Q critics, target networks, entropy
temperature auto-tuning, squashed-Gaussian actor.

Counterpart of `raptor_tpu/rl/sac.py`. Where the JAX package maps one pure
update over a population axis with `jax.vmap`, every tensor here may carry a
leading [K] axis (parameters [K, in, out], batches [K, B, d], `log_alpha`
[K]) and one call updates K independent learners with batched matmuls. Each
loss that is differentiated is the sum over members of that member's mean, so
a member's gradient is what it would be alone; one `torch.optim.Adam` over the
stacked tensors is then K independent Adams (the update is elementwise).

`SACState` is a mutable dataclass: parameters are leaf tensors updated in
place by the optimizers it carries.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from raptor_tpu_torch.rl import networks


@dataclasses.dataclass(frozen=True)
class SACConfig:
    gamma: float = 0.99
    tau: float = 0.005  # polyak rate for target critics
    actor_lr: float = 3e-4
    critic_lr: float = 3e-4
    alpha_lr: float = 3e-4
    init_alpha: float = 0.2
    target_entropy_per_dim: float = -1.0  # target_entropy = c * action_dim
    actor_hidden: Tuple[int, ...] = (64, 64)
    critic_hidden: Tuple[int, ...] = (64, 64)
    # 'bfloat16' rounds the operands of the actor and critic matmuls (forward
    # and backward) to bf16, with f32 accumulation (`networks.matmul_lp`);
    # master weights, losses, targets and optimizer state remain f32.
    # None = f32 throughout.
    compute_dtype: Optional[str] = None
    # run the twin critics as one batched matmul per layer (the same numbers)
    stack_critics: bool = False
    # run the Adam update as multi-tensor ("foreach") calls over all leaves of
    # an optimizer at once instead of a loop over the leaves: the same
    # arithmetic. False leaves PyTorch's default, which is already foreach on
    # a CUDA device and the per-leaf loop on the CPU.
    flat_optim: bool = False

    @property
    def _dtype(self):
        if self.compute_dtype is None:
            return None
        return getattr(torch, self.compute_dtype)


@dataclasses.dataclass
class SACState:
    actor: dict
    critic: dict
    target_critic: dict
    log_alpha: torch.Tensor  # [] or [K]
    actor_opt: torch.optim.Adam
    critic_opt: torch.optim.Adam
    alpha_opt: torch.optim.Adam
    step: int


class SACMetrics(NamedTuple):
    critic_loss: torch.Tensor  # each [] or [K]
    actor_loss: torch.Tensor
    alpha_loss: torch.Tensor
    alpha: torch.Tensor
    q1_mean: torch.Tensor
    entropy: torch.Tensor


def adam(leaves, lr: float, foreach: Optional[bool] = None) -> torch.optim.Adam:
    """`optax.adam`'s arithmetic: eps 1e-8 outside the square root."""
    return torch.optim.Adam(leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8, foreach=foreach)


def make_optimizers(config: SACConfig, actor, critic, log_alpha):
    """The three Adams over the leaves of the actor, the critic and the
    temperature."""
    foreach = True if config.flat_optim else None
    return (
        adam(networks.tree_leaves(actor), config.actor_lr, foreach),
        adam(networks.tree_leaves(critic), config.critic_lr, foreach),
        adam([log_alpha], config.alpha_lr, foreach),
    )


def make_state(actor, critic, target_critic, log_alpha, config: SACConfig, step: int = 0):
    """A `SACState` around given parameter trees, with fresh optimizers. The
    actor, critic and temperature become leaves that record gradients."""
    for leaf in (*networks.tree_leaves(actor), *networks.tree_leaves(critic), log_alpha):
        leaf.requires_grad_(True)
    actor_opt, critic_opt, alpha_opt = make_optimizers(config, actor, critic, log_alpha)
    return SACState(
        actor=actor, critic=critic, target_critic=target_critic, log_alpha=log_alpha,
        actor_opt=actor_opt, critic_opt=critic_opt, alpha_opt=alpha_opt, step=step,
    )


def sac_init(
    generator: torch.Generator, obs_dim: int, action_dim: int,
    config: SACConfig = SACConfig(), n_stack: Optional[int] = None,
) -> SACState:
    """A fresh learner on the generator's device; with `n_stack` = K, K
    independent learners stacked on a leading axis."""
    actor = networks.actor_init(generator, obs_dim, action_dim, config.actor_hidden, n_stack)
    critic = networks.critic_init(generator, obs_dim, action_dim, config.critic_hidden, n_stack)
    target = networks.tree_clone(critic)
    log_alpha = torch.full(() if n_stack is None else (n_stack,), math.log(config.init_alpha),
                           dtype=torch.float32, device=generator.device)
    return make_state(actor, critic, target, log_alpha, config)


def average_over(group, tensors):
    """The mean of each tensor over the processes of `group`, in one
    all_reduce of their concatenation; every process gets the same values."""
    world = dist.get_world_size(group)
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    flat /= world
    return [v.view_as(t) for v, t in zip(flat.split([t.numel() for t in tensors]), tensors)]


def _step(opt: torch.optim.Adam, loss: torch.Tensor, group=None) -> None:
    """One Adam step on the gradient of `loss` with respect to the
    optimizer's leaves, and of nothing else; with a process group, on that
    gradient averaged over the group's processes."""
    leaves = [p for group_ in opt.param_groups for p in group_["params"]]
    grads = torch.autograd.grad(loss, leaves)
    if group is not None:
        grads = average_over(group, grads)
    for p, g in zip(leaves, grads):
        p.grad = g
    opt.step()
    opt.zero_grad(set_to_none=True)


def sac_update(
    state: SACState,
    generator: Optional[torch.Generator],
    batch: Tuple[torch.Tensor, ...],  # (obs, action, reward, next_obs, done)
    config: SACConfig = SACConfig(),
    noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    group=None,
) -> Tuple[SACState, SACMetrics]:
    """One SAC gradient step on a minibatch [B, d], or on K minibatches
    [K, B, d] for K stacked learners. Updates `state` in place.

    With a process group (`torch.distributed`), `batch` is this process's
    equal share of the minibatch and the learner is replicated: each
    gradient is averaged over the group before its Adam step, which equals
    one step on the whole minibatch, and leaves the learners of all the
    processes equal. The metrics are averaged too.

    `noise` = (eps for the next-state action, eps for the policy action), each
    of the actions' shape, replaces the draws from the generator where given.
    Order: the critic target uses the old actor and the target critic; the
    actor loss runs through the updated critic; the temperature loss sees the
    actor loss's log-probabilities, detached; polyak comes last."""
    obs, action, reward, next_obs, done = batch
    target_entropy = config.target_entropy_per_dim * action.shape[-1]
    dtype, stacked = config._dtype, config.stack_critics
    eps_next, eps_pi = noise if noise is not None else (None, None)

    # ---- critic update ----
    with torch.no_grad():
        alpha = torch.exp(state.log_alpha)
        next_action, next_logp = networks.actor_sample(
            state.actor, next_obs, generator, dtype=dtype, eps=eps_next)
        tq1, tq2 = networks.critic_apply(
            state.target_critic, next_obs, next_action, dtype=dtype, stacked=stacked)
        target_v = torch.minimum(tq1, tq2) - alpha[..., None] * next_logp
        target_q = reward + config.gamma * (1.0 - done) * target_v

    q1, q2 = networks.critic_apply(state.critic, obs, action, dtype=dtype, stacked=stacked)
    critic_loss = torch.mean((q1 - target_q) ** 2, -1) + torch.mean((q2 - target_q) ** 2, -1)
    q1_mean = q1.detach().mean(-1)
    _step(state.critic_opt, critic_loss.sum(), group)

    # ---- actor update, through the updated critic ----
    pi, logp = networks.actor_sample(state.actor, obs, generator, dtype=dtype, eps=eps_pi)
    pq1, pq2 = networks.critic_apply(state.critic, obs, pi, dtype=dtype, stacked=stacked)
    actor_loss = torch.mean(alpha[..., None] * logp - torch.minimum(pq1, pq2), -1)
    logp = logp.detach()
    _step(state.actor_opt, actor_loss.sum(), group)

    # ---- temperature update ----
    alpha_loss = -torch.mean(torch.exp(state.log_alpha)[..., None] * (logp + target_entropy), -1)
    _step(state.alpha_opt, alpha_loss.sum(), group)

    # ---- polyak target ----
    networks.polyak_(state.target_critic, state.critic, config.tau)
    with torch.no_grad():
        new_alpha = torch.exp(state.log_alpha)

    state.step += 1
    metrics = SACMetrics(
        critic_loss=critic_loss.detach(),
        actor_loss=actor_loss.detach(),
        alpha_loss=alpha_loss.detach(),
        alpha=new_alpha,
        q1_mean=q1_mean,
        entropy=-logp.mean(-1),
    )
    if group is not None:
        metrics = SACMetrics(*average_over(group, list(metrics)))
    return state, metrics
