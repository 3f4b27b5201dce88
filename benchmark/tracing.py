"""The device trace of a short steady sub-window: `torch.profiler` with CPU
and CUDA activity, read in memory from the profiler's raw events (no file is
written).

From it: the seconds in which an operation ran on the device (the union of
kernel, copy and set intervals), the traced window's length on the host's
clock, kernel launches, the device time of the kernels whose name holds a
given string, and the breakdown (device operations by time; idle gaps by the
host operation that launched the kernel or copy ending each gap).

Each device event is joined to the CUDA runtime or driver call that launched
it by their shared correlation id (`launch`), so that a device event has a
time on the host's clock. Its own device time is not compared with host
times: on an H100 under torch 2.11 the device's timestamps stand off the
host's by an offset and a drift that differ from process to process (up to
14 ms over a 3.5 s trace). The program's phase spans (`raptor.*` ranges) are
kept apart from the host operators; `spans.py` reads both.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

NAME_CHARS = 120
SPAN_PREFIX = "raptor."  # the program's phase spans (`raptor_tpu_torch.utils.profiling.span`)
LAUNCH_PREFIX = "cu"  # the CUDA runtime and driver calls: cudaLaunchKernel, cuLaunchKernel, ...
OUTSIDE_OPS = "host outside any operator"


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
        self.spans: List[Tuple[str, int, int]] = []
        self.launch: Dict[Tuple[str, int, int], int] = {}  # device event -> its launch's host ns
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
        optimizer's step) left out; host operators, the program's spans and
        the launch of each device event apart."""
        cpu = torch.autograd.DeviceType.CPU
        launch_ns: Dict[int, int] = {}
        device_corr: Dict[Tuple[str, int, int], int] = {}
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
                device_corr[span] = ev.correlation_id()
            elif name.startswith(LAUNCH_PREFIX):
                launch_ns[ev.correlation_id()] = span[1]
            elif name.startswith(SPAN_PREFIX):
                self.spans.append(span)
            elif not name.startswith("ProfilerStep"):
                self.host_ops.append(span)
        self.launch = {k: launch_ns[c] for k, c in device_corr.items() if c in launch_ns}

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

    def gaps(self) -> List[Tuple[int, int]]:
        """(idle ns, host ns of the launch that ends it) of each gap between
        the intervals of `busy_intervals`: the launch of the kernel or copy
        that starts the next interval, on the host's clock. Where that launch
        is not in the trace, the gap's middle on the device's clock stands in
        for it."""
        out: List[Tuple[int, int]] = []
        end = None
        for ev in sorted(self.kernels + self.copies, key=lambda s: s[1]):
            if end is not None and ev[1] > end:
                out.append((ev[1] - end, self.launch.get(ev, (end + ev[1]) // 2)))
            end = ev[2] if end is None else max(end, ev[2])
        return out

    def idle_gaps(self, k: int = 10):
        """Idle device time grouped by the widest host operation holding the
        launch of the kernel or copy that ends each gap (gaps inside the
        traced device span): the host work the card waited for."""
        outer: List[Tuple[str, int, int]] = []  # host operations not inside another
        for name, a, b in sorted(self.host_ops, key=lambda s: (s[1], -s[2])):
            if not outer or a >= outer[-1][2]:
                outer.append((name, a, b))
        starts = [a for _, a, _ in outer]
        total = defaultdict(int)
        for idle, t in self.gaps():
            i = bisect.bisect_right(starts, t) - 1
            hit = i >= 0 and outer[i][2] >= t
            total[outer[i][0][:NAME_CHARS] if hit else OUTSIDE_OPS] += idle
        return [[n, t * 1e-9] for n, t in sorted(total.items(), key=lambda x: -x[1])[:k]]
