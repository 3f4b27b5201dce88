"""Failure detection: NaN and divergence guards for long training runs.

Counterpart of `raptor_tpu/utils/guards.py`. `nonfinite_leaves` scans a
state (dataclasses, dicts, lists, tuples, tensors, optimizer moments) for
non-finite values and names each path; `FailureDetectionStep` plugs into the
`rl.loop` chain and either raises or rolls back to the last good snapshot.

The port's learners update their state in place, so a snapshot that keeps a
reference to the state keeps the very object that diverged. `Snapshot`
copies the values instead (tensors, each optimizer's state, each generator's
state, the plain numbers) and writes them back into the same objects on
restore, so the optimizers keep their parameters.
"""

from __future__ import annotations

import copy
import math
from typing import Any, Callable, List, Optional

import torch

from raptor_tpu_torch.utils.state_checkpoint import leaves_with_path, write_leaf


def _finite(x) -> bool:
    if isinstance(x, torch.Tensor):
        return not x.is_floating_point() or bool(torch.isfinite(x).all())
    if isinstance(x, float):
        return math.isfinite(x)
    return True


def nonfinite_leaves(tree: Any, max_report: int = 8) -> List[str]:
    """Paths of the leaves holding non-finite values (empty = healthy)."""
    bad = []
    for path, _, _, leaf in leaves_with_path(tree):
        if isinstance(leaf, torch.optim.Optimizer):
            named = [(f"{path}.state[{i}][{k!r}]", v)
                     for i, st in leaf.state_dict()["state"].items() for k, v in st.items()]
        else:
            named = [(path, leaf)]
        bad.extend(p for p, v in named if not _finite(v))
        if len(bad) >= max_report:
            return bad[:max_report]
    return bad


def check_pytree(tree: Any, what: str = "state") -> None:
    bad = nonfinite_leaves(tree)
    if bad:
        raise FloatingPointError(f"non-finite values in {what}: {bad}")


class DivergenceError(RuntimeError):
    pass


def _copy(leaf):
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().clone()
    if isinstance(leaf, torch.optim.Optimizer):
        return copy.deepcopy(leaf.state_dict()["state"])
    if isinstance(leaf, torch.Generator):
        return leaf.get_state()
    return leaf


class Snapshot:
    """A copy of a state's values, restored into the same objects:

        snap = Snapshot()
        FailureDetectionStep(snapshot_fn=snap.take, restore_fn=snap.restore)
    """

    def __init__(self):
        self.state = None
        self.values = None

    def take(self, state: Any) -> None:
        self.state = state
        self.values = [_copy(leaf) for _, _, _, leaf in leaves_with_path(state)]

    def restore(self) -> Any:
        """Write the copied values back into the state; returns it. The copy
        stays intact, so it can be restored again."""
        if self.state is None:
            raise RuntimeError("no snapshot taken")
        for (_, parent, key, leaf), value in zip(leaves_with_path(self.state), self.values):
            # the optimizer takes over the tensors it is given: hand it a copy
            write_leaf(parent, key, leaf, copy.deepcopy(value)
                       if isinstance(leaf, torch.optim.Optimizer) else value)
        return self.state


class FailureDetectionStep:
    """Loop step: every `every_iters`, check metrics and (optionally) the
    trainer state for non-finite values; on failure, restore the last good
    snapshot if a restore_fn is provided, else raise DivergenceError."""

    def __init__(
        self,
        every_iters: int = 10,
        check_state: bool = False,
        snapshot_fn: Optional[Callable[[Any], None]] = None,
        restore_fn: Optional[Callable[[], Any]] = None,
        max_restores: int = 3,
    ):
        self.every_iters = every_iters
        self.check_state = check_state
        self.snapshot_fn = snapshot_fn
        self.restore_fn = restore_fn
        self.max_restores = max_restores
        self.restores = 0

    def __call__(self, holder, run=None):
        if holder.iteration % self.every_iters:
            return
        bad = []
        if holder.last_metrics is not None:
            m = holder.last_metrics
            values = m._asdict() if hasattr(m, "_asdict") else (
                m if isinstance(m, dict) else {}
            )
            bad = [f"metrics.{k}" for k, v in values.items() if not _finite(v)]
        if self.check_state and not bad:
            bad = [f"state{p}" for p in nonfinite_leaves(holder.state)]

        if not bad:
            if self.snapshot_fn is not None:
                self.snapshot_fn(holder.state)
            return

        if run is not None:
            run.log({"failure/nonfinite": 1.0}, holder.total_env_steps)
        if self.restore_fn is not None and self.restores < self.max_restores:
            holder.state = self.restore_fn()
            self.restores += 1
            return
        raise DivergenceError(f"training diverged: non-finite {bad}")
