"""Device-resident replay rings for the SAC teachers and the recurrent learner.

Counterpart of `raptor_tpu/rl/replay.py`. `TransitionBuffer`: flat
(s, a, r, s', done) transitions stored as [C, N, d] arrays (C time rows of N
envs), written at a ring pointer and sampled as random (time, env) pairs or as
whole time rows. A population of K learners is the same buffer with a leading
[K] axis on every array, [K, C, N, d], one ring per member advancing in
lockstep; each member draws its own sample. `SequenceBuffer`: the same ring of
time rows with a `reset` column, sampled as [B, T] windows for BPTT.

The buffer is a mutable dataclass and the writes are in place
(`index_copy_`): the ring is allocated once. `ptr` and `size` are plain ints.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass
class TransitionBuffer:
    obs: torch.Tensor  # [..., C, N, obs_dim]
    action: torch.Tensor  # [..., C, N, act_dim]
    reward: torch.Tensor  # [..., C, N]
    next_obs: torch.Tensor  # [..., C, N, obs_dim]
    done: torch.Tensor  # [..., C, N] float (1.0 = terminated; truncation excluded)
    ptr: int  # ring pointer
    size: int  # filled rows

    @property
    def capacity(self) -> int:
        return self.obs.shape[-3]

    @property
    def n_envs(self) -> int:
        return self.obs.shape[-2]

    @property
    def lead(self) -> Tuple[int, ...]:
        """() for one learner, (K,) for a population."""
        return tuple(self.obs.shape[:-3])

    def arrays(self):
        """(array, number of trailing feature axes) for the five fields."""
        return ((self.obs, 1), (self.action, 1), (self.reward, 0), (self.next_obs, 1),
                (self.done, 0))


def transition_buffer_init(
    capacity: int, n_envs: int, obs_dim: int, action_dim: int, device,
    n_stack: Optional[int] = None,
) -> TransitionBuffer:
    lead = () if n_stack is None else (n_stack,)

    def zeros(*tail):
        return torch.zeros((*lead, capacity, n_envs, *tail), dtype=torch.float32, device=device)

    return TransitionBuffer(
        obs=zeros(obs_dim), action=zeros(action_dim), reward=zeros(), next_obs=zeros(obs_dim),
        done=zeros(), ptr=0, size=0,
    )


@torch.no_grad()
def transition_buffer_add_rollout(
    buf: TransitionBuffer,
    obs: torch.Tensor,  # [..., H, N, obs_dim]: a whole collected rollout at once
    action: torch.Tensor,
    reward: torch.Tensor,  # [..., H, N]
    next_obs: torch.Tensor,
    done: torch.Tensor,
) -> TransitionBuffer:
    """Ring write of H time rows, wrapping by index modulo the capacity.
    Writes into `buf`."""
    h, cap = obs.shape[-3], buf.capacity
    idx = (buf.ptr + torch.arange(h, device=buf.obs.device)) % cap
    for (arr, tail), rows in zip(buf.arrays(), (obs, action, reward, next_obs, done)):
        arr.index_copy_(arr.dim() - 2 - tail, idx, rows.to(arr.dtype))
    buf.ptr = (buf.ptr + h) % cap
    buf.size = min(buf.size + h, cap)
    return buf


def transition_buffer_add(
    buf: TransitionBuffer,
    obs: torch.Tensor,  # [..., N, obs_dim]
    action: torch.Tensor,
    reward: torch.Tensor,
    next_obs: torch.Tensor,
    done: torch.Tensor,
) -> TransitionBuffer:
    """Append one time row of transitions for all envs. Writes into `buf`."""
    return transition_buffer_add_rollout(
        buf, obs.unsqueeze(-3), action.unsqueeze(-3), reward.unsqueeze(-2),
        next_obs.unsqueeze(-3), done.unsqueeze(-2),
    )


def _randint(generator, shape, high: int, device) -> torch.Tensor:
    return torch.randint(0, max(high, 1), shape, generator=generator, device=device)


def _member_index(buf: TransitionBuffer):
    """Index tuple that pairs each member of the population with its own
    draws ([K, 1] against [K, B]); empty for one learner."""
    if not buf.lead:
        return ()
    return (torch.arange(buf.lead[0], device=buf.obs.device)[:, None],)


def transition_buffer_sample(
    buf: TransitionBuffer, generator: Optional[torch.Generator], batch_size: int,
    idx: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, ...]:
    """Uniform minibatch over (filled time rows) x (envs): five arrays
    [..., B, d]. `idx` = (time rows, envs), each [..., B], replaces the draws
    from the generator where given."""
    if idx is None:
        shape, dev = (*buf.lead, batch_size), buf.obs.device
        idx = (_randint(generator, shape, buf.size, dev),
               _randint(generator, shape, buf.n_envs, dev))
    where = (*_member_index(buf), *idx)
    return tuple(arr[where] for arr, _ in buf.arrays())


def transition_buffer_sample_rows(
    buf: TransitionBuffer, generator: Optional[torch.Generator], batch_size: int,
    idx: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, ...]:
    """Row-contiguous minibatch: `batch_size / n_envs` whole time rows (all
    envs of each row) instead of scattered (time, env) pairs. The envs of a row
    are independent trajectories, so the samples of a batch share at most
    `rows` distinct time steps. `idx` ([..., rows] time rows) replaces the
    draws from the generator where given."""
    rows, rem = divmod(batch_size, buf.n_envs)
    if rem or rows < 1:
        raise ValueError(
            f"batch_size {batch_size} must be a positive multiple of "
            f"n_envs {buf.n_envs} for row sampling"
        )
    if idx is None:
        idx = _randint(generator, (*buf.lead, rows), buf.size, buf.obs.device)
    where = (*_member_index(buf), idx)
    lead = buf.lead
    return tuple(
        arr[where].reshape(*lead, batch_size, *arr.shape[len(lead) + 2:])
        for arr, _ in buf.arrays()
    )


# ---------------------------------------------------------------------------
# sequence replay (GRU / BPTT)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SequenceBuffer:
    """Ring of time rows with episode-boundary masks, sampled as fixed-length
    windows for BPTT. Stores (obs, action, reward, terminated) per step plus a
    `reset` flag on the first row of an episode, so a sampled window knows
    where to re-inject the learned initial hidden state."""

    obs: torch.Tensor  # [C, N, obs_dim]
    action: torch.Tensor  # [C, N, act_dim]
    reward: torch.Tensor  # [C, N]
    done: torch.Tensor  # [C, N] terminated (bootstrapping mask)
    reset: torch.Tensor  # [C, N] 1.0 where this row starts a new episode
    ptr: int
    size: int

    @property
    def capacity(self) -> int:
        return self.obs.shape[0]

    @property
    def n_envs(self) -> int:
        return self.obs.shape[1]

    def arrays(self):
        return (self.obs, self.action, self.reward, self.done, self.reset)


def sequence_buffer_init(
    capacity: int, n_envs: int, obs_dim: int, action_dim: int, device
) -> SequenceBuffer:
    def zeros(*tail):
        return torch.zeros((capacity, n_envs, *tail), dtype=torch.float32, device=device)

    return SequenceBuffer(obs=zeros(obs_dim), action=zeros(action_dim), reward=zeros(),
                          done=zeros(), reset=zeros(), ptr=0, size=0)


@torch.no_grad()
def sequence_buffer_add_rollout(
    buf: SequenceBuffer,
    obs: torch.Tensor,  # [H, N, obs_dim]
    action: torch.Tensor,
    reward: torch.Tensor,  # [H, N]
    done: torch.Tensor,
    reset: torch.Tensor,
) -> SequenceBuffer:
    """Ring write of H time rows. Writes into `buf`."""
    h, cap = obs.shape[0], buf.capacity
    idx = (buf.ptr + torch.arange(h, device=buf.obs.device)) % cap
    for arr, rows in zip(buf.arrays(), (obs, action, reward, done, reset)):
        arr.index_copy_(0, idx, rows.to(arr.dtype))
    buf.ptr = (buf.ptr + h) % cap
    buf.size = min(buf.size + h, cap)
    return buf


def sequence_buffer_sample(
    buf: SequenceBuffer, generator: Optional[torch.Generator], batch_size: int, seq_len: int,
    idx: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> dict:
    """[B, T] windows: a dict of [B, T, ...] tensors plus `env_idx` [B].

    Windows are drawn from filled rows in logical (time) order: logical index
    0 is the oldest surviving row, so once the ring wraps a window never
    straddles the write pointer. A window starts at t0 in [0, max(size - T,
    1)), exclusive at the top; where size < T every window starts at 0.
    `idx` = (t0, env), each [B], replaces the draws from the generator."""
    if idx is None:
        dev = buf.obs.device
        idx = (_randint(generator, (batch_size,), buf.size - seq_len, dev),
               _randint(generator, (batch_size,), buf.n_envs, dev))
    t0, e_idx = idx
    base = (buf.ptr - buf.size + buf.capacity) % buf.capacity
    t_idx = (base + t0[:, None] + torch.arange(seq_len, device=t0.device)[None, :]) % buf.capacity
    e_full = e_idx[:, None].expand(-1, seq_len)
    out = {name: arr[t_idx, e_full] for name, arr in zip(
        ("obs", "action", "reward", "done", "reset"), buf.arrays())}
    out["env_idx"] = e_idx
    return out
