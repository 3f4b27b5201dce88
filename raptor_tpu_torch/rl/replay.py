"""Device-resident replay ring for the SAC teachers.

Counterpart of `TransitionBuffer` in `raptor_tpu/rl/replay.py`: flat
(s, a, r, s', done) transitions stored as [C, N, d] arrays (C time rows of N
envs), written at a ring pointer and sampled as random (time, env) pairs or as
whole time rows. A population of K learners is the same buffer with a leading
[K] axis on every array, [K, C, N, d], one ring per member advancing in
lockstep; each member draws its own sample.

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
