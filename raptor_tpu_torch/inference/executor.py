"""Host-side inference executor mirror (Python).

Counterpart of `raptor_tpu/inference/executor.py`. Same multi-rate contract
as the native executor (`native/executor.cpp`): intermediate-rate calls
(400-500 Hz) run the policy forward WITHOUT advancing the GRU state; every
`force_sync_native`-th call commits (the 100 Hz native rate). Useful for
sim-rate experiments and as the executable spec the native C++ is tested
against.

The parameters and the hidden state live on the executor's device (the card
unless `device="cpu"`); each call copies the observation there and the
action back. Matmuls run in full f32: the package turns TF32 off.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from raptor_tpu_torch.device import resolve_device
from raptor_tpu_torch.policy import network


@dataclasses.dataclass(frozen=True)
class ExecutorConfig:
    """The reference executor's constants."""

    action_history_length: int = 1
    control_interval_intermediate_ns: int = 2_500_000  # 400 Hz
    control_interval_native_ns: int = 10_000_000  # 100 Hz (training rate)
    force_sync_intermediate: bool = True
    force_sync_native: int = 4
    timing_stats_num_steps: int = 100
    warning_levels: Tuple[float, float, float] = (1.05, 1.25, 2.0)


STATUS_OK = 0
STATUS_TIMING_L1 = 1 << 0
STATUS_TIMING_L2 = 1 << 1
STATUS_TIMING_L3 = 1 << 2


class Executor:
    """`params`: the port's parameter dict of tensors, or of numpy arrays
    (put on the device through `checkpoint.from_numpy`)."""

    def __init__(self, params, config: ExecutorConfig = ExecutorConfig(), device="cuda"):
        from raptor_tpu_torch.checkpoint import from_numpy

        self.device = resolve_device(device)
        if all(isinstance(v, torch.Tensor) for t in params.values() for v in t.values()):
            self.params = {layer: {k: v.detach().to(self.device, torch.float32)
                                   for k, v in t.items()} for layer, t in params.items()}
        else:
            self.params = from_numpy(params, self.device)
        self.config = config
        self.reset()

    def reset(self):
        self.hidden = network.initial_hidden(self.params, 1)
        self.last_call_ns: Optional[int] = None
        self.call_count = 0
        self.intervals_ns: list = []

    def _timing_status(self, now_ns: int) -> int:
        if self.last_call_ns is None:
            return STATUS_OK
        dt = now_ns - self.last_call_ns
        window = self.config.timing_stats_num_steps
        self.intervals_ns.append(dt)
        if len(self.intervals_ns) > window:
            self.intervals_ns.pop(0)
        expected = self.config.control_interval_intermediate_ns
        ratio = dt / expected if dt > expected else expected / max(dt, 1)
        levels = self.config.warning_levels
        if ratio > levels[2]:
            return STATUS_TIMING_L3
        if ratio > levels[1]:
            return STATUS_TIMING_L2
        if ratio > levels[0]:
            return STATUS_TIMING_L1
        return STATUS_OK

    def control(self, time_us: int, observation: np.ndarray) -> Tuple[np.ndarray, int]:
        """obs[22] -> action[4], status bitmask."""
        now_ns = int(time_us) * 1000
        status = self._timing_status(now_ns)
        self.last_call_ns = now_ns
        commit = (self.call_count % self.config.force_sync_native) == 0
        obs = torch.tensor(np.asarray(observation, np.float32)[None], device=self.device)
        with torch.no_grad():
            h_new, action = network.apply_step(self.params, self.hidden, obs)
        if commit:
            self.hidden = h_new
        self.call_count += 1
        return np.clip(action[0].cpu().numpy(), -1.0, 1.0), status

    def timing_stats(self) -> Tuple[float, float]:
        if not self.intervals_ns:
            return 0.0, 0.0
        arr = np.asarray(self.intervals_ns, np.float64)
        return float(arr.mean()), float(arr.max())
