"""extrack: experiment tracking with timestamped run directories and config
snapshots.

The port's own copy of the framework-free `raptor_tpu/utils/extrack.py`:
experiments live under `<base>/<experiment>/<timestamp>/` with checkpoints per
step and a tfevents log; the experiment name comes from the
RAPTOR_EXTRACK_EXPERIMENT environment variable, with a timestamp default.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Optional

from raptor_tpu_torch.utils.tfevents import SummaryWriter


def _timestamp() -> str:
    return time.strftime("%Y-%m-%d_%H-%M-%S")


class Run:
    """One experiment run directory: logs + checkpoints + config snapshot."""

    def __init__(
        self,
        base_dir: str = "experiments",
        experiment: Optional[str] = None,
        name: str = "",
    ):
        experiment = experiment or os.environ.get(
            "RAPTOR_EXTRACK_EXPERIMENT", _timestamp()
        )
        self.timestamp = _timestamp()
        leaf = self.timestamp + (f"_{name}" if name else "")
        self.dir = os.path.join(base_dir, experiment, leaf)
        os.makedirs(self.dir, exist_ok=True)
        self.checkpoint_dir = os.path.join(self.dir, "checkpoints")
        os.makedirs(self.checkpoint_dir, exist_ok=True)
        self.writer = SummaryWriter(self.dir)
        self.name = f"logs/{leaf}"

    def snapshot_config(self, config: Any, filename: str = "config.json"):
        def enc(o):
            if dataclasses.is_dataclass(o) and not isinstance(o, type):
                return dataclasses.asdict(o)
            if hasattr(o, "tolist"):
                return o.tolist()
            return str(o)

        with open(os.path.join(self.dir, filename), "w") as f:
            json.dump(config, f, indent=2, default=enc)

    def checkpoint_path(self, step: int, suffix: str = ".h5") -> str:
        return os.path.join(self.checkpoint_dir, f"{step:012d}{suffix}")

    def log(self, values: dict, step: int):
        self.writer.scalars(values, step)
        self.writer.flush()

    def close(self):
        self.writer.close()
