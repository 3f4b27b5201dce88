"""Profiling and tracing utilities.

Counterpart of `raptor_tpu/utils/profiling.py`: `device_trace` records a
`torch.profiler` trace of the enclosed block (host and, where a card is in
use, CUDA activity) and writes it as a Chrome trace (viewable in Perfetto or
chrome://tracing). `span` marks a phase of the program: while a profiler is
recording, the phase is a `raptor.<name>` range on the host's timeline, over
the operators it ran and, through their launches, the kernels they queued on
the card, all on the profiler's one clock. The program opens spans at phase
boundaries only (a distillation step's gather, forward, backward and
optimizer; an evaluation's sample, reset, pack, launch, unpack and summary),
never inside a time-step loop. With no profiler running a span costs one
check and records nothing.

`launches` tallies the launches of the port's hand-written kernels, by
wrapper (`ops/rollout.py`, `ops/eval.py`, `ops/collect.py`, `ops/fma_peak.py`,
`ops/bptt.py`): each wrapper adds what it launched; a kernel inside a CUDA
graph counts at each replay (`utils/graphs.py`); plain versions on the CPU
add nothing. The bench, the dry run, `bench_scaling` and `chip_smoke.py` read
it and set it to zero with `reset_launches`.
"""

from __future__ import annotations

import collections
import contextlib
import os

import torch

_NO_SPAN = contextlib.nullcontext()
KERNELS = ("rollout", "eval", "collect", "fma_peak", "bptt")
launches = collections.Counter(dict.fromkeys(KERNELS, 0))


def reset_launches() -> None:
    """Every kernel's count in `launches` to 0."""
    for k in launches:
        launches[k] = 0


def synchronize() -> None:
    """Wait for every CUDA launch of this process so far; nothing where CUDA
    was never initialised (a CPU run)."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def span(name: str):
    """A context manager around one phase: `record_function("raptor." +
    name)` while a profiler records, else a shared null context. The
    enclosing span on the same thread is its parent."""
    if not torch.autograd._profiler_enabled():
        return _NO_SPAN
    return torch.profiler.record_function("raptor." + name)


@contextlib.contextmanager
def device_trace(logdir: str):
    """Record a `torch.profiler` trace of the enclosed block into
    `<logdir>/trace.json`:

        with device_trace('experiments/traces/run0') as prof:
            state, _ = super_step(state, params)

    The card's activity is recorded where CUDA is available, and the block is
    synchronised before the trace stops. Yields the profiler, whose
    `key_averages()` sums the time by operator and kernel; the trace shows
    the program's `raptor.*` spans over their operators and kernels."""
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
