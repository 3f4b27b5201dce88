"""`Raptor` — the inference API of the reference `foundation_policy` package:
`Raptor()`, `.reset()`, `.evaluate_step(obs [B, 22]) -> action [B, 4]`, with
the hidden state kept per batch row.

Counterpart of `raptor_tpu/policy/raptor.py`.
"""

from __future__ import annotations

import glob
import os
import tarfile
from typing import Optional

import numpy as np
import torch

from raptor_tpu_torch.device import resolve_device
from raptor_tpu_torch.policy import network

_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), ".cache"
)
_REFERENCE_ENV = "RAPTOR_REFERENCE_DIR"
_SHIPPED_TGZ = os.path.join("data", "raptor-policy-checkpoint.tar.gz")


def shipped_checkpoint_path() -> str:
    """Extract (once, into the repository's `.cache/`) and return the shipped
    reference checkpoint.h5. The tarball is read from the reference raptor
    checkout named by $RAPTOR_REFERENCE_DIR; raises FileNotFoundError when
    neither the extracted file nor the tarball is there."""
    hits = glob.glob(os.path.join(_CACHE_DIR, "*", "checkpoint.h5"))
    if hits:
        return hits[0]
    tgz = os.path.join(os.environ.get(_REFERENCE_ENV, ""), _SHIPPED_TGZ)
    if not os.environ.get(_REFERENCE_ENV) or not os.path.exists(tgz):
        raise FileNotFoundError(
            f"shipped checkpoint not found: set {_REFERENCE_ENV} to a checkout "
            f"of the reference raptor repository holding {_SHIPPED_TGZ}"
        )
    os.makedirs(_CACHE_DIR, exist_ok=True)
    with tarfile.open(tgz) as tar:
        tar.extractall(_CACHE_DIR, filter="data")
    hits = glob.glob(os.path.join(_CACHE_DIR, "*", "checkpoint.h5"))
    if not hits:
        raise FileNotFoundError("checkpoint.h5 not found in shipped tarball")
    return hits[0]


class Raptor:
    """Stateful batched inference around the foundation policy.

    >>> policy = Raptor("raptor_tpu_torch/data/student_rateFlagCurMix.npz")
    >>> policy.reset()                      # h := learned initial hidden state
    >>> action = policy.evaluate_step(obs)  # obs [B, 22] -> action [B, 4]
    """

    def __init__(
        self, checkpoint_path: Optional[str] = None, batch_size: int = 1, device="cuda"
    ):
        from raptor_tpu_torch.checkpoint import from_numpy, h5

        self.device = resolve_device(device)
        if checkpoint_path is None:
            checkpoint_path = shipped_checkpoint_path()
        self.params = from_numpy(h5.load_actor(checkpoint_path), self.device)
        self.batch_size = batch_size
        self.reset()

    def reset(self) -> None:
        """Reset every row's hidden state to the learned initial hidden state."""
        self.hidden = network.initial_hidden(self.params, self.batch_size)

    def evaluate_step(self, observation) -> np.ndarray:
        """obs [B, 22] (or [22]) -> action [B, 4]; advances the hidden state."""
        obs = torch.as_tensor(np.asarray(observation, np.float32), device=self.device)
        squeeze = obs.dim() == 1
        if squeeze:
            obs = obs[None]
        if obs.shape[0] != self.hidden.shape[0]:
            # resize hidden to the incoming batch (fresh rows get h0)
            self.batch_size = obs.shape[0]
            self.reset()
        with torch.no_grad():
            self.hidden, action = network.apply_step(self.params, self.hidden, obs)
        out = action.cpu().numpy()
        return out[0] if squeeze else out
