"""Recurrent SAC: a GRU actor and twin recurrent critics trained by BPTT over
replayed sequences.

Counterpart of `raptor_tpu/rl/sac_gru.py`. The actor is the foundation
policy's backbone (Dense -> GRU(16) -> Dense, `policy.network`) with a
squashed-Gaussian (mu, log_std) head; the critics are GRU networks of the same
layout over (obs, action). Windows come from `replay.SequenceBuffer`: where a
window's `reset` flag is set the learned initial hidden state is re-injected,
and targets are not bootstrapped across a truncation seam.

The recurrence is a Python loop over `network.apply_step`, so the learned
`initial_hidden_state` stays in the autograd graph through every reset
(`torch.nn.GRU` cannot re-inject h0 inside a sequence and keeps its weights in
another layout). `SACGRUState` is a mutable dataclass whose parameters are
leaf tensors updated in place by the optimizers it carries.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Tuple

import torch

from raptor_tpu_torch.policy import network as gru_net
from raptor_tpu_torch.rl import networks
from raptor_tpu_torch.rl.sac import _step, adam


@dataclasses.dataclass(frozen=True)
class SACGRUConfig:
    gamma: float = 0.99
    tau: float = 0.005
    actor_lr: float = 3e-4
    critic_lr: float = 3e-4
    alpha_lr: float = 3e-4
    init_alpha: float = 0.2
    target_entropy_per_dim: float = -1.0
    hidden_dim: int = 16  # GRU width (foundation policy: 16)
    log_std_min: float = -10.0
    log_std_max: float = 2.0
    # R2D2-style burn-in: the first `burn_in` steps of a window only warm up
    # the hidden states and are masked out of every loss.
    burn_in: int = 0
    # Asymmetric actor-critic: when set, the batch obs is the full privileged
    # observation; the critics see all of it and the actor only
    # obs[..., :actor_obs_dim]. None = symmetric.
    actor_obs_dim: Optional[int] = None
    # critic GRU width (None = hidden_dim); the actor keeps the foundation width
    critic_hidden_dim: Optional[int] = None


@dataclasses.dataclass
class SACGRUState:
    actor: dict
    critic1: dict
    critic2: dict
    target1: dict
    target2: dict
    log_alpha: torch.Tensor  # []
    actor_opt: torch.optim.Adam
    critic_opt: torch.optim.Adam  # one Adam over both critics: one shared count
    alpha_opt: torch.optim.Adam
    step: int


class SACGRUMetrics(NamedTuple):
    critic_loss: torch.Tensor
    actor_loss: torch.Tensor
    alpha: torch.Tensor
    entropy: torch.Tensor


def _scan_gru(params, seq: torch.Tensor, reset: torch.Tensor, h0_batch: torch.Tensor):
    """A GRU network over [T, B, in], re-injecting `h0_batch` before each
    step whose reset flag is set; returns [T, B, out]."""
    h, out = h0_batch, []
    for x_t, reset_t in zip(seq, reset):
        h = torch.where(reset_t[:, None] != 0, h0_batch, h)
        h, y = gru_net.apply_step(params, h, x_t)
        out.append(y)
    return torch.stack(out)


def actor_forward(params, obs_seq: torch.Tensor, reset: torch.Tensor, config: SACGRUConfig):
    """[T, B, obs] -> (mu, log_std), each [T, B, act]."""
    h0 = gru_net.initial_hidden(params, obs_seq.shape[1])
    mu, log_std = _scan_gru(params, obs_seq, reset, h0).chunk(2, -1)
    return mu, torch.clamp(log_std, config.log_std_min, config.log_std_max)


def critic_forward(params, obs_seq: torch.Tensor, action_seq: torch.Tensor, reset: torch.Tensor):
    """[T, B, obs] and [T, B, act] -> q [T, B]."""
    x = torch.cat([obs_seq, action_seq], -1)
    h0 = gru_net.initial_hidden(params, x.shape[1])
    return _scan_gru(params, x, reset, h0)[..., 0]


def actor_optimizer(config: SACGRUConfig, actor: dict) -> torch.optim.Adam:
    return adam(networks.tree_leaves(actor), config.actor_lr)


def make_state(actor, critic1, critic2, target1, target2, log_alpha,
               config: SACGRUConfig, step: int = 0) -> SACGRUState:
    """A `SACGRUState` around given parameter trees, with fresh optimizers.
    The actor, critics and temperature become leaves that record gradients."""
    for leaf in (*networks.tree_leaves((actor, critic1, critic2)), log_alpha):
        leaf.requires_grad_(True)
    return SACGRUState(
        actor=actor, critic1=critic1, critic2=critic2, target1=target1, target2=target2,
        log_alpha=log_alpha,
        actor_opt=actor_optimizer(config, actor),
        critic_opt=adam(networks.tree_leaves((critic1, critic2)), config.critic_lr),
        alpha_opt=adam([log_alpha], config.alpha_lr),
        step=step,
    )


def sac_gru_init(
    generator: torch.Generator, obs_dim: int, action_dim: int,
    config: SACGRUConfig = SACGRUConfig(),
) -> SACGRUState:
    """A fresh learner on the generator's device."""
    h = config.hidden_dim
    hc = config.critic_hidden_dim or h
    actor = gru_net.init_params(generator, config.actor_obs_dim or obs_dim, h, 2 * action_dim)
    critic1 = gru_net.init_params(generator, obs_dim + action_dim, hc, 1)
    critic2 = gru_net.init_params(generator, obs_dim + action_dim, hc, 1)
    log_alpha = torch.tensor(math.log(config.init_alpha), dtype=torch.float32,
                             device=generator.device)
    return make_state(actor, critic1, critic2, networks.tree_clone(critic1),
                      networks.tree_clone(critic2), log_alpha, config)


@torch.no_grad()
def graft_actor_from_student(actor: dict, student: dict, action_dim: int,
                             init_log_std: float = -2.0) -> dict:
    """A squashed-Gaussian GRU actor initialised from a distilled student (RL
    fine-tuning): dense_0 and gru_1 copy exactly; the student's action head
    becomes the mu half of the 2 * action_dim head, and the log-std half gets
    zero weights and a constant `init_log_std` bias. The student deploys
    clip(identity) and the SAC actor tanh(mu), so the grafted actions are
    tanh-compressed: exact for small actions, about 20 % shrunk near 0.9.

    `student` holds arrays or tensors; the result lies on the actor's device
    and shares no storage with either input."""
    dev = actor["dense_2"]["weights"].device

    def t(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev).clone()

    if tuple(student["gru_1"]["initial_hidden_state"].shape) != tuple(
            actor["gru_1"]["initial_hidden_state"].shape):
        raise ValueError("student hidden width must match the SAC actor's")
    w2 = actor["dense_2"]["weights"].detach().clone()
    b2 = actor["dense_2"]["biases"].detach().clone()
    w2[:action_dim] = t(student["dense_2"]["weights"])
    w2[action_dim:] = 0.0
    b2[:action_dim] = t(student["dense_2"]["biases"])
    b2[action_dim:] = init_log_std
    return {
        "dense_0": {k: t(v) for k, v in student["dense_0"].items()},
        "gru_1": {k: t(v) for k, v in student["gru_1"].items()},
        "dense_2": {"weights": w2, "biases": b2},
    }


def set_actor(state: SACGRUState, actor: dict, config: SACGRUConfig) -> SACGRUState:
    """Replace the learner's actor (for example by a grafted one) and give it
    a fresh Adam, as the JAX CLI re-initialises the actor optimizer."""
    for leaf in networks.tree_leaves(actor):
        leaf.requires_grad_(True)
    state.actor = actor
    state.actor_opt = actor_optimizer(config, actor)
    return state


def sac_gru_update(
    state: SACGRUState,
    generator: Optional[torch.Generator],
    batch: dict,  # SequenceBuffer sample: [B, T, ...]
    config: SACGRUConfig = SACGRUConfig(),
    noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[SACGRUState, SACGRUMetrics]:
    """One BPTT gradient step on a batch of windows. Updates `state` in place.

    Transitions bootstrap t -> t+1 inside the window. Terminal transitions
    train on target = r and stay in the loss; a truncation seam (reset[t+1]
    without done[t]) leaves it. `noise` = (eps for the target's actions, eps
    for the policy's actions), each [T, B, act], replaces the draws from the
    generator. Order: the critic target uses the old actor and alpha; the
    actor loss runs through the updated critics; the temperature loss sees
    the actor loss's log-probabilities, detached; polyak comes last."""
    obs, action, reward, done, reset = (
        batch[k].transpose(0, 1) for k in ("obs", "action", "reward", "done", "reset"))
    T, B = reward.shape
    reset = reset.clone()
    reset[0] = 1.0  # windows start fresh
    target_entropy = config.target_entropy_per_dim * action.shape[-1]
    eps_next, eps_pi = noise if noise is not None else (None, None)
    a_obs = obs if config.actor_obs_dim is None else obs[..., : config.actor_obs_dim]

    # ---- targets: the old actor's action at every step, target critics ----
    with torch.no_grad():
        alpha = torch.exp(state.log_alpha)
        mu_n, log_std_n = actor_forward(state.actor, a_obs, reset, config)
        a_next, logp_next = networks.sample_and_squash(mu_n, log_std_n, generator, eps_next)
        v_next = torch.minimum(critic_forward(state.target1, obs, a_next, reset),
                               critic_forward(state.target2, obs, a_next, reset)
                               ) - alpha * logp_next
        valid = torch.maximum(1.0 - reset[1:], done[:-1])  # [T-1, B]
        trained = (torch.arange(T, device=obs.device) >= config.burn_in).float()  # [T]
        valid = valid * trained[:-1, None]
        w_actor = trained[:, None].expand(T, B)
        n_actor = torch.clamp(w_actor.sum(), min=1.0)
        target_q = reward[:-1] + config.gamma * (1.0 - done[:-1]) * v_next[1:]
        denom = torch.clamp(valid.sum(), min=1.0)

    # ---- critics ----
    q1 = critic_forward(state.critic1, obs, action, reset)[:-1]
    q2 = critic_forward(state.critic2, obs, action, reset)[:-1]
    critic_loss = (torch.sum(valid * (q1 - target_q) ** 2) / denom
                   + torch.sum(valid * (q2 - target_q) ** 2) / denom)
    _step(state.critic_opt, critic_loss)

    # ---- actor, through the updated critics ----
    mu, log_std = actor_forward(state.actor, a_obs, reset, config)
    pi, logp = networks.sample_and_squash(mu, log_std, generator, eps_pi)
    q = torch.minimum(critic_forward(state.critic1, obs, pi, reset),
                      critic_forward(state.critic2, obs, pi, reset))
    actor_loss = torch.sum(w_actor * (alpha * logp - q)) / n_actor
    logp = logp.detach()
    _step(state.actor_opt, actor_loss)

    # ---- temperature ----
    alpha_loss = -torch.sum(w_actor * torch.exp(state.log_alpha) * (logp + target_entropy)) / n_actor
    _step(state.alpha_opt, alpha_loss)

    # ---- polyak targets ----
    networks.polyak_((state.target1, state.target2), (state.critic1, state.critic2), config.tau)
    with torch.no_grad():
        new_alpha = torch.exp(state.log_alpha)

    state.step += 1
    return state, SACGRUMetrics(
        critic_loss=critic_loss.detach(),
        actor_loss=actor_loss.detach(),
        alpha=new_alpha,
        entropy=-torch.sum(w_actor * logp) / n_actor,
    )


def recurrent_actor_step(actor_params, config: SACGRUConfig = SACGRUConfig()):
    """(hidden, obs [B, D]) -> (hidden, tanh(mu)): the deterministic action,
    for evaluation rollouts."""

    def step(h, obs):
        h, out = gru_net.apply_step(actor_params, h, obs)
        return h, torch.tanh(out.chunk(2, -1)[0])

    return step
