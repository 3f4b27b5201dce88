"""Composable training-loop steps.

The port's own copy of `raptor_tpu/rl/loop.py`: core (collect + train),
evaluation, checkpoint, extrack and timing steps, each owning its cadence,
driving any super-step function `(state, params) -> (state, metrics)`. The
reference cadences (evaluation every ~77.5k env steps, a checkpoint per
evaluation) are the defaults. `TimingStep` waits for the card before it reads
the clock, so a rate covers the work done, not the work queued.

    loop = Loop(
        CoreStep(super_step_fn, params),
        EvaluationStep(eval_fn, every_env_steps=77_500),
        CheckpointStep(save_fn, every_env_steps=77_500),
        TimingStep(),
        extrack_run=run,
    )
    while loop.total_env_steps < budget:
        loop.step(state_holder)
"""

from __future__ import annotations

import time
from typing import Any, Callable, Optional

from raptor_tpu_torch.utils.profiling import synchronize


class StateHolder:
    """Mutable box for the trainer state (the loop steps share it)."""

    def __init__(self, state: Any, env_steps_per_iter: int):
        self.state = state
        self.env_steps_per_iter = env_steps_per_iter
        self.total_env_steps = 0
        self.iteration = 0
        self.last_metrics: Any = None


class CoreStep:
    """collect + train (the super-step)."""

    def __init__(self, super_step: Callable, params: Any):
        self.super_step = super_step
        self.params = params

    def __call__(self, holder: StateHolder, run=None):
        holder.state, holder.last_metrics = self.super_step(
            holder.state, self.params
        )
        holder.total_env_steps += holder.env_steps_per_iter
        holder.iteration += 1


class _CadenceStep:
    def __init__(self, every_env_steps: int):
        self.every_env_steps = every_env_steps
        self._last_fired = 0  # bucket 0 == "before the first cadence point"

    def due(self, holder: StateHolder) -> bool:
        if self.every_env_steps <= 0:
            return False
        bucket = holder.total_env_steps // self.every_env_steps
        if bucket > self._last_fired:
            self._last_fired = bucket
            return True
        return False


class EvaluationStep(_CadenceStep):
    """Periodic deterministic evaluation; logs the 5-stat contract under the
    reference tag names."""

    def __init__(
        self,
        eval_fn: Callable[[Any], dict],
        every_env_steps: int = 77_500,
        tag_prefix: str = "evaluation",
    ):
        super().__init__(every_env_steps)
        self.eval_fn = eval_fn
        self.tag_prefix = tag_prefix

    def __call__(self, holder: StateHolder, run=None):
        if not self.due(holder):
            return
        stats = self.eval_fn(holder.state)
        if run is not None:
            run.log(
                {f"{self.tag_prefix}/{k}": float(v) for k, v in stats.items()},
                holder.total_env_steps,
            )


class CheckpointStep(_CadenceStep):
    def __init__(self, save_fn: Callable[[Any, int], None], every_env_steps: int):
        super().__init__(every_env_steps)
        self.save_fn = save_fn

    def __call__(self, holder: StateHolder, run=None):
        if self.due(holder):
            self.save_fn(holder.state, holder.total_env_steps)


class ExtrackStep(_CadenceStep):
    """Streams training metrics into the extrack run's tfevents."""

    def __init__(self, every_env_steps: int = 0, metric_fn: Optional[Callable] = None):
        super().__init__(every_env_steps or 1)
        self.metric_fn = metric_fn

    def __call__(self, holder: StateHolder, run=None):
        if run is None or holder.last_metrics is None or not self.due(holder):
            return
        metrics = holder.last_metrics
        if self.metric_fn is not None:
            values = self.metric_fn(metrics)
        elif hasattr(metrics, "_asdict") or isinstance(metrics, dict):
            items = metrics.items() if isinstance(metrics, dict) else metrics._asdict().items()
            values = {k: float(v) for k, v in items}
        else:
            values = {"metric": float(metrics)}
        run.log(values, holder.total_env_steps)


class TimingStep:
    """Wall-clock + throughput tracking (reference steps::timing). Reads the
    clock after the card has finished the work launched so far."""

    def __init__(self, log_every_iters: int = 10):
        self.log_every_iters = log_every_iters
        self.t0 = None
        self.steps0 = 0

    def __call__(self, holder: StateHolder, run=None):
        if self.t0 is not None and holder.iteration % self.log_every_iters:
            return
        synchronize()
        now = time.perf_counter()
        if self.t0 is None:
            self.t0 = now
            self.steps0 = holder.total_env_steps
            return
        dt = now - self.t0
        dsteps = holder.total_env_steps - self.steps0
        if run is not None and dt > 0:
            run.log({"timing/env_steps_per_s": dsteps / dt}, holder.total_env_steps)
        self.t0, self.steps0 = now, holder.total_env_steps


class Loop:
    """Runs the step chain in order each iteration (core first by
    convention, like the reference's nested wrappers)."""

    def __init__(self, *steps, extrack_run=None):
        self.steps = steps
        self.run = extrack_run

    def step(self, holder: StateHolder):
        for s in self.steps:
            s(holder, self.run)

    def run_until(self, holder: StateHolder, env_step_budget: int):
        while holder.total_env_steps < env_step_budget:
            self.step(holder)
        return holder
