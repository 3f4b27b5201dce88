"""Flight-log schema + I/O for real-flight evaluation.

Copy of `raptor_tpu/utils/flightlog.py` (numpy only), so the port never
imports the JAX package; a log written by either package reads in the other.
One CSV schema is shared by the sim-side recorder (`apps/flight_eval.py
record`), the analysis and replay tooling (`apps/flight_eval.py
analyze|replay`) and any hardware bridge (a Vicon or MAVLink adapter writes
the same rows).

Schema (header row required, SI units, l2f frame convention: FLU world
position, body->world quaternion wxyz, world linear velocity, body angular
velocity, motor commands in the policy's [-1, 1] frame):

    t_us,px,py,pz,qw,qx,qy,qz,vx,vy,vz,wx,wy,wz,a0,a1,a2,a3

Action columns are optional (mocap-only logs omit them).
"""

from __future__ import annotations

import csv
from typing import NamedTuple, Optional

import numpy as np

COLUMNS = (
    "t_us",
    "px", "py", "pz",
    "qw", "qx", "qy", "qz",
    "vx", "vy", "vz",
    "wx", "wy", "wz",
    "a0", "a1", "a2", "a3",
)
_STATE_COLS = COLUMNS[1:14]


class FlightLog(NamedTuple):
    """Columnar flight log. All arrays [T]; actions may be None."""

    t_us: np.ndarray          # int64 [T]
    position: np.ndarray      # f32 [T, 3]
    orientation: np.ndarray   # f32 [T, 4] (w, x, y, z)
    linear_velocity: np.ndarray   # f32 [T, 3]
    angular_velocity: np.ndarray  # f32 [T, 3]
    action: Optional[np.ndarray]  # f32 [T, 4] or None

    @property
    def duration_s(self) -> float:
        return float(self.t_us[-1] - self.t_us[0]) / 1e6 if len(self.t_us) > 1 else 0.0

    @property
    def dt_s(self) -> float:
        return float(np.mean(np.diff(self.t_us))) / 1e6 if len(self.t_us) > 1 else 0.0


def write_csv(path: str, log: FlightLog) -> None:
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        has_action = log.action is not None
        w.writerow(COLUMNS if has_action else COLUMNS[:14])
        for i in range(len(log.t_us)):
            row = [int(log.t_us[i])]
            row += [f"{v:.7g}" for v in log.position[i]]
            row += [f"{v:.7g}" for v in log.orientation[i]]
            row += [f"{v:.7g}" for v in log.linear_velocity[i]]
            row += [f"{v:.7g}" for v in log.angular_velocity[i]]
            if has_action:
                row += [f"{v:.7g}" for v in log.action[i]]
            w.writerow(row)


def read_csv(path: str) -> FlightLog:
    with open(path, newline="") as f:
        r = csv.reader(f)
        header = next(r)
        if tuple(header[:14]) != COLUMNS[:14]:
            raise ValueError(
                f"unrecognized flight-log header {header[:14]} "
                f"(expected {COLUMNS[:14]})"
            )
        has_action = len(header) >= 18
        rows = [row for row in r if row]
    data = np.asarray(rows, dtype=np.float64)
    return FlightLog(
        t_us=data[:, 0].astype(np.int64),
        position=data[:, 1:4].astype(np.float32),
        orientation=data[:, 4:8].astype(np.float32),
        linear_velocity=data[:, 8:11].astype(np.float32),
        angular_velocity=data[:, 11:14].astype(np.float32),
        action=data[:, 14:18].astype(np.float32) if has_action else None,
    )
