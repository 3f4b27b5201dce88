"""The program's phase spans in the device trace of a traced sub-window: the
`raptor.*` ranges that `raptor_tpu_torch.utils.profiling.span` records while
a profiler runs, which `tracing.DeviceTrace` keeps apart from the host
operators (so that `idle_gaps` still groups the gaps by the widest operator,
where a span would otherwise be the widest).

Each device kernel is put in the innermost span that holds its launch's host
time (`DeviceTrace.launch`: the kernel and the CUDA runtime or driver call
that launched it share a correlation id, and the call's host time is on the
spans' clock). The kernel's own device time is not used: it lags its launch,
and the device's clock stands off the host's. An idle gap likewise goes to
the span that launched the kernel or copy ending it (`DeviceTrace.gaps`). A
span's self time is its duration less what its child spans cover. `of(ctx)`
reads the run's trace once for every reader.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

from tracing import NAME_CHARS, SPAN_PREFIX as PREFIX

OUTSIDE = "outside any program span"

Span = Tuple[str, int, int]


def innermost(spans: Sequence[Span], times: Sequence[int]) -> List[Optional[int]]:
    """For each time, the index in `spans` of the innermost span holding it
    (start <= t <= end), else None. Spans nest or are disjoint, as the ranges
    of one thread are."""
    order = sorted(range(len(spans)), key=lambda i: (spans[i][1], -spans[i][2]))
    out: List[Optional[int]] = [None] * len(times)
    stack: List[int] = []
    j = 0
    for k in sorted(range(len(times)), key=times.__getitem__):
        t = times[k]
        while j < len(order) and spans[order[j]][1] <= t:
            while stack and spans[stack[-1]][2] <= spans[order[j]][1]:
                stack.pop()
            stack.append(order[j])
            j += 1
        while stack and spans[stack[-1]][2] < t:
            stack.pop()
        out[k] = stack[-1] if stack else None
    return out


class SpanTrace:
    """The spans of one `DeviceTrace`, and its kernels put in them."""

    def __init__(self, trace):
        self.trace = trace
        self.spans: List[Span] = trace.spans
        self.launch = trace.launch  # device event -> the host time of the call that launched it
        launched = [k for k in trace.kernels if k in self.launch]
        where = innermost(self.spans, [self.launch[k] for k in launched])
        # (kernel, launch host ns, index of its span or None)
        self.kernel_span = [(k, self.launch[k], i) for k, i in zip(launched, where)]

    # -- checks of the attribution ----------------------------------------
    def unattributed(self) -> int:
        """Kernels whose launch call is not in the trace."""
        return len(self.trace.kernels) - len(self.kernel_span)

    def early(self) -> Tuple[int, Optional[int]]:
        """(kernels that start on the device before their launch's host time,
        the least device start minus launch time in ns)."""
        leads = [k[1] - t for k, t, _ in self.kernel_span]
        return sum(d < 0 for d in leads), (min(leads) if leads else None)

    # -- readings ---------------------------------------------------------
    def stats(self) -> Dict[str, dict]:
        """By span name: calls, host seconds (total and self), the kernels
        launched inside it and not in a child (launches) and their device
        seconds."""
        out: Dict[str, dict] = defaultdict(
            lambda: {"calls": 0, "host_s": 0.0, "self_s": 0.0, "launches": 0, "device_s": 0.0})
        parents = innermost_parents(self.spans)
        covered = defaultdict(int)
        for i, p in enumerate(parents):
            if p is not None:
                covered[p] += self.spans[i][2] - self.spans[i][1]
        for i, (name, a, b) in enumerate(self.spans):
            s = out[name]
            s["calls"] += 1
            s["host_s"] += (b - a) * 1e-9
            s["self_s"] += (b - a - covered[i]) * 1e-9
        for (_, a, b), _, i in self.kernel_span:
            if i is not None:
                s = out[self.spans[i][0]]
                s["launches"] += 1
                s["device_s"] += (b - a) * 1e-9
        return dict(out)

    def outside_launches(self) -> int:
        """Kernels launched outside every span."""
        return sum(i is None for _, _, i in self.kernel_span)

    def span_stats(self, k: int = 10):
        """[name, calls, host s, self s, launches, device s] of the k spans
        with the most host time."""
        rows = sorted(self.stats().items(), key=lambda x: -x[1]["host_s"])[:k]
        return [[n[:NAME_CHARS], s["calls"], s["host_s"], s["self_s"], s["launches"],
                 s["device_s"]] for n, s in rows]

    def idle_by_span(self, k: int = 10):
        """The gaps that `DeviceTrace.idle_gaps` reads, each put in the
        innermost span that holds the launch of the kernel or copy that ends
        it: the host work the card waited for (`DeviceTrace.gaps`)."""
        gaps = self.trace.gaps()
        total = defaultdict(int)
        for (idle, _), i in zip(gaps, innermost(self.spans, [t for _, t in gaps])):
            total[OUTSIDE if i is None else self.spans[i][0][:NAME_CHARS]] += idle
        return [[n, t * 1e-9] for n, t in sorted(total.items(), key=lambda x: -x[1])[:k]]


def innermost_parents(spans: Sequence[Span]) -> List[Optional[int]]:
    """For each span, the index of the span that directly holds it, else None."""
    order = sorted(range(len(spans)), key=lambda i: (spans[i][1], -spans[i][2]))
    parents: List[Optional[int]] = [None] * len(spans)
    stack: List[int] = []
    for i in order:
        while stack and spans[stack[-1]][2] <= spans[i][1]:
            stack.pop()
        parents[i] = stack[-1] if stack else None
        stack.append(i)
    return parents


def of(ctx) -> Optional[SpanTrace]:
    """The run's `SpanTrace`, read once; None without a device trace."""
    tr = ctx.device_trace
    if tr is None:
        return None
    if "program_spans" not in ctx.stats:
        ctx.stats["program_spans"] = SpanTrace(tr)
    return ctx.stats["program_spans"]


def units(ctx) -> int:
    """Gradient steps or requests in the traced sub-window."""
    traffic = ctx.cell.traffic
    return traffic["trace_steps"] * traffic.get("steps_per_call", 1)


def host_ms(ctx, names: Sequence[str]) -> Optional[float]:
    """Host milliseconds a unit of the traced sub-window spends in the spans
    `names` (without the prefix); None where none of them was recorded."""
    st = of(ctx)
    stats = st.stats() if st is not None else {}
    hits = [stats[PREFIX + n] for n in names if PREFIX + n in stats]
    if not hits:
        return None
    return 1000.0 * sum(s["host_s"] for s in hits) / units(ctx)


def launches(ctx, names: Sequence[str]) -> Optional[float]:
    """Kernels a unit that the spans `names` launch (their children's
    apart); None without kernels or without those spans."""
    st = of(ctx)
    if st is None or not st.trace.launches():
        return None
    stats = st.stats()
    hits = [stats[PREFIX + n] for n in names if PREFIX + n in stats]
    if not hits:
        return None
    return sum(s["launches"] for s in hits) / units(ctx)
