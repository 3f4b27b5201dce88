"""Profiling and tracing utilities.

Counterpart of `raptor_tpu/utils/profiling.py`: `device_trace` records a
`torch.profiler` trace of the enclosed block (host and, where a card is in
use, CUDA activity) and writes it as a Chrome trace (viewable in Perfetto or
chrome://tracing); `Timers` is a registry of named wall-clock accumulators for
the training loop. PyTorch launches CUDA work asynchronously, so a timer that
reads the clock without waiting measures the enqueue: `synchronize` waits for
the card where CUDA is in use.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict

import torch


def synchronize() -> None:
    """Wait for every CUDA launch of this process so far; nothing where CUDA
    was never initialised (a CPU run)."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def device_trace(logdir: str):
    """Record a `torch.profiler` trace of the enclosed block into
    `<logdir>/trace.json`:

        with device_trace('experiments/traces/run0') as prof:
            state, _ = super_step(state, params)

    The card's activity is recorded where CUDA is available, and the block is
    synchronised before the trace stops. Yields the profiler, whose
    `key_averages()` sums the time by operator and kernel."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class Timers:
    """Named wall-clock accumulators (host side). With `synchronize=True` a
    region is timed to the end of its CUDA work, not to its last launch."""

    def __init__(self, synchronize: bool = False):
        self.synchronize = synchronize
        self.total: Dict[str, float] = defaultdict(float)
        self.count: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def time(self, name: str):
        if self.synchronize:
            synchronize()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.synchronize:
                synchronize()
            self.total[name] += time.perf_counter() - t0
            self.count[name] += 1

    def summary(self) -> Dict[str, float]:
        return {
            name: self.total[name] / max(self.count[name], 1)
            for name in self.total
        }

    def report(self) -> str:
        lines = [
            f"{name}: total {self.total[name]:.3f}s mean "
            f"{self.total[name] / max(self.count[name], 1) * 1e3:.2f}ms "
            f"x{self.count[name]}"
            for name in sorted(self.total)
        ]
        return "\n".join(lines)
