"""The device trace of a short steady sub-window: `torch.profiler` with CPU
and CUDA activity, read in memory from the profiler's raw events (no file is
written).

From it: the seconds in which an operation ran on the device (the union of
kernel, copy and set intervals), the traced window's length on the host's
clock, kernel launches, the device time of the kernels whose name holds a
given string, and the breakdown (device operations by time; idle gaps by the
host operation in progress at their middle).
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from typing import List, Optional, Tuple

import torch

NAME_CHARS = 120


def _ns(ev, which: str) -> int:
    fn = getattr(ev, f"{which}_ns", None)
    if fn is not None:
        return int(fn())
    if which == "start":
        return int(ev.start_us() * 1000)
    return int((ev.start_us() + ev.duration_us()) * 1000)


class DeviceTrace:
    """Context manager: synchronizes, profiles the block, synchronizes, and
    keeps the events. On a device without CUDA it records host events only,
    and every device reading is empty."""

    def __init__(self, device: torch.device):
        self.device = device
        self.kernels: List[Tuple[str, int, int]] = []
        self.copies: List[Tuple[str, int, int]] = []
        self.host_ops: List[Tuple[str, int, int]] = []
        self.window_s = 0.0

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        self._sync()
        self._prof = profile(activities=activities)
        self._prof.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        self.window_s = time.perf_counter() - self._t0
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self._read(self._prof.profiler.kineto_results.events())
        return False

    def _read(self, events):
        """Device events by kind (kernels; copies and sets), with the user
        annotations that a library records on the device timeline (such as an
        optimizer's step) left out; host operators and annotations apart."""
        cpu = torch.autograd.DeviceType.CPU
        for ev in events:
            name = ev.name()
            span = (name, _ns(ev, "start"), _ns(ev, "end"))
            kind = ev.activity_type() if hasattr(ev, "activity_type") else ""
            annotation = "annotation" in kind or getattr(ev, "is_user_annotation", bool)()
            if ev.device_type() != cpu:
                if annotation:
                    continue
                copy = kind in ("gpu_memcpy", "gpu_memset") or name.startswith(
                    ("Memcpy", "Memset"))
                (self.copies if copy else self.kernels).append(span)
            elif not name.startswith(("cuda", "cu", "ProfilerStep")):
                self.host_ops.append(span)

    # -- readings -------------------------------------------------------
    def launches(self) -> int:
        return len(self.kernels)

    def busy_intervals(self) -> List[Tuple[int, int]]:
        merged: List[List[int]] = []
        for _, a, b in sorted(self.kernels + self.copies, key=lambda s: s[1]):
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-9

    def idle_pct(self) -> Optional[float]:
        if not self.kernels or self.window_s <= 0:
            return None
        return 100.0 * (1.0 - self.busy_s() / self.window_s)

    def kernel_seconds(self, name_part: str) -> Tuple[float, int]:
        """(device seconds, launches) of the kernels whose name holds name_part."""
        hits = [b - a for name, a, b in self.kernels if name_part in name]
        return sum(hits) * 1e-9, len(hits)

    def top_device_ops(self, k: int = 10):
        total = defaultdict(int)
        for name, a, b in self.kernels + self.copies:
            total[name[:NAME_CHARS]] += b - a
        return [[n, t * 1e-9] for n, t in sorted(total.items(), key=lambda x: -x[1])[:k]]

    def idle_gaps(self, k: int = 10):
        """Idle device time grouped by the widest host operation in progress
        at each gap's middle (gaps inside the traced device span)."""
        busy = self.busy_intervals()
        outer: List[Tuple[str, int, int]] = []  # host operations not inside another
        for name, a, b in sorted(self.host_ops, key=lambda s: (s[1], -s[2])):
            if not outer or a >= outer[-1][2]:
                outer.append((name, a, b))
        starts = [a for _, a, _ in outer]
        total = defaultdict(int)
        for (_, end), (start, _) in zip(busy[:-1], busy[1:]):
            mid = (end + start) // 2
            i = bisect.bisect_right(starts, mid) - 1
            hit = i >= 0 and outer[i][2] >= mid
            name = outer[i][0][:NAME_CHARS] if hit else "host outside any operator"
            total[name] += start - end
        return [[n, t * 1e-9] for n, t in sorted(total.items(), key=lambda x: -x[1])[:k]]
