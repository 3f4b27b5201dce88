"""One forward step of the foundation policy as `(fn, example_args)`.

Counterpart of `entry()` in the JAX package's `__graft_entry__.py`: the
flagship model (Dense 22->16, GRU 16, Dense 16->4) with freshly initialized
weights, a batch of 256 zero observations and the initial hidden state.
"""

from __future__ import annotations

import torch

from raptor_tpu_torch.device import resolve_device
from raptor_tpu_torch.policy import network


def entry(device="cuda", batch: int = 256):
    """Returns (fn, example_args) with `fn(params, h, obs) -> action
    [batch, 4]` and the example tensors on `device`."""
    device = resolve_device(device)
    params = network.init_params(torch.Generator(device=device).manual_seed(0))
    obs = torch.zeros((batch, network.OBS_DIM), dtype=torch.float32, device=device)
    h = network.initial_hidden(params, batch)

    def fn(params, h, obs):
        _, action = network.apply_step(params, h, obs)
        return action

    return fn, (params, h, obs)
