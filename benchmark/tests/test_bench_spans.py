"""The program's spans in the device trace (`spans.py`): kernels go to the
innermost span that holds their launch, joined by correlation id; self time
leaves out the children; keeping the spans apart from the host operators
leaves every reading of `DeviceTrace` as it is without them; an idle gap
goes to the widest host operator holding the launch that ends it, whatever
the offset of the device's clock; the span metrics read a traced cell, and
nothing where the program records no span."""

from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import tinycell

import core
import spans
import tracing
from tracing import DeviceTrace

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


class Ev:
    """An event with the part of the profiler's event interface the readers use."""

    def __init__(self, name, start, end, kind, corr=0):
        self._name, self._start, self._end, self._kind, self._corr = name, start, end, kind, corr

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def end_ns(self):
        return self._end

    def activity_type(self):
        return self._kind

    def is_user_annotation(self):
        return self._kind.endswith("user_annotation")

    def device_type(self):
        return CUDA if self._kind in ("kernel", "gpu_memcpy", "gpu_user_annotation") else CPU

    def correlation_id(self):
        return self._corr


def trace_of(events, window_s=1.0):
    tr = DeviceTrace(torch.device("cpu"))
    tr._read(events)
    tr.window_s = window_s
    return tr


def launched(name, host_ns, device_start, device_end, corr):
    """A kernel and the runtime call that launched it."""
    return [Ev("cudaLaunchKernel", host_ns, host_ns + 2, "cuda_runtime", corr),
            Ev(name, device_start, device_end, "kernel", corr)]


def test_kernels_go_to_the_innermost_span_of_their_launch():
    events = [
        Ev("raptor.distill.step", 0, 100, "user_annotation"),
        Ev("raptor.distill.gather", 10, 20, "user_annotation"),
        Ev("raptor.distill.forward", 20, 60, "user_annotation"),
        Ev("aten::mm", 25, 55, "cpu_op"),
        Ev("raptor.distill.step", 200, 260, "user_annotation"),
        Ev("raptor.distill.forward", 210, 250, "user_annotation"),
        Ev("Optimizer.step#Adam.step", 70, 90, "gpu_user_annotation"),
    ]
    events += launched("k_gather", 15, 65, 70, 1)  # runs on the device during the forward
    events += launched("k_forward", 30, 75, 80, 2)
    events += launched("k_step", 70, 85, 95, 3)  # in the step, in no child
    events += launched("k_outside", 150, 160, 170, 4)
    events += launched("k_forward", 220, 230, 240, 5)
    events.append(Ev("k_lost", 300, 310, "kernel", 99))  # its launch is not in the trace
    st = spans.SpanTrace(trace_of(events))
    stats = st.stats()
    assert stats["raptor.distill.gather"]["launches"] == 1
    assert stats["raptor.distill.forward"]["launches"] == 2
    assert stats["raptor.distill.forward"]["calls"] == 2
    assert stats["raptor.distill.step"]["launches"] == 1
    assert st.outside_launches() == 1 and st.unattributed() == 1
    assert stats["raptor.distill.step"]["host_s"] == pytest.approx(160e-9)
    assert stats["raptor.distill.step"]["self_s"] == pytest.approx((50 + 20) * 1e-9)
    assert stats["raptor.distill.forward"]["self_s"] == pytest.approx(80e-9)
    assert stats["raptor.distill.forward"]["device_s"] == pytest.approx(15e-9)
    assert st.early() == (0, 10)  # k_step starts 15 ns after its launch
    names = [row[0] for row in st.span_stats()]
    assert names[0] == "raptor.distill.step" and len(names) == 3
    # busy: [65, 70], [75, 80], [85, 95], [160, 170], [230, 240], [300, 310]; each gap goes
    # to the span of the launch that ends it (30: forward; 70: step; 150: outside; 220:
    # forward), the last to its middle (270: outside), as k_lost's launch is not traced
    idle = dict(st.idle_by_span())
    assert idle == pytest.approx({"raptor.distill.forward": 65e-9, "raptor.distill.step": 5e-9,
                                  spans.OUTSIDE: 125e-9})
    assert sum(idle.values()) == pytest.approx(sum(t for _, t in st.trace.idle_gaps()))


MS = 1_000_000  # ns


def middle_rule(tr):
    """The idle gaps grouped by the widest host operator in progress at each
    gap's middle on the device's clock: the attribution `idle_gaps` made
    before it followed the closing launch."""
    outer = []
    for name, a, b in sorted(tr.host_ops, key=lambda s: (s[1], -s[2])):
        if not outer or a >= outer[-1][2]:
            outer.append((name, a, b))
    busy, total = tr.busy_intervals(), {}
    for (_, end), (start, _) in zip(busy[:-1], busy[1:]):
        mid = (end + start) // 2
        hit = [n for n, a, b in outer if a <= mid <= b]
        name = hit[0] if hit else tracing.OUTSIDE_OPS
        total[name] = total.get(name, 0) + start - end
    return {n: t * 1e-9 for n, t in total.items()}


def test_idle_gaps_follow_the_closing_launch_across_a_clock_offset():
    """The device's clock 14 ms ahead of the host's: each gap goes to the
    widest operator holding the launch of the kernel that ends it, and the
    middle of the gap, read against host operators, would name operators
    that launched nothing."""
    off = 14 * MS
    events = [
        Ev("aten::index", 0, 1 * MS, "cpu_op"),
        Ev("aten::outer", 4 * MS, 6 * MS, "cpu_op"),
        Ev("aten::inner", 4 * MS + 10, 5 * MS, "cpu_op"),  # inside aten::outer
        Ev("aten::item", 15 * MS, 20 * MS, "cpu_op"),  # launches nothing
        Ev("raptor.env.reset", 3 * MS, 7 * MS, "user_annotation"),
    ]
    events += launched("k_first", 100, off + 200, off + 1 * MS, 1)
    events += launched("k_second", 4 * MS + 100, off + 5 * MS, off + 6 * MS, 2)  # in aten::inner
    events += launched("k_third", 8 * MS, off + 9 * MS, off + 10 * MS, 3)  # in no operator
    tr = trace_of(events)
    gaps = dict(tr.idle_gaps())
    assert gaps == pytest.approx({"aten::outer": 4 * MS * 1e-9,
                                  tracing.OUTSIDE_OPS: 3 * MS * 1e-9})
    # the middles (17 ms and 21.5 ms on the device's clock) fall in aten::item or after it
    assert middle_rule(tr) == pytest.approx({"aten::item": 4 * MS * 1e-9,
                                             tracing.OUTSIDE_OPS: 3 * MS * 1e-9})
    assert sum(gaps.values()) == pytest.approx(sum(middle_rule(tr).values()))
    assert dict(spans.SpanTrace(tr).idle_by_span()) == pytest.approx(
        {"raptor.env.reset": 4 * MS * 1e-9, spans.OUTSIDE: 3 * MS * 1e-9})


def test_idle_gap_falls_back_to_its_middle_without_the_launch():
    """A gap whose closing kernel has no launch in the trace goes to the
    widest operator at its middle; the others still follow their launch."""
    events = [Ev("aten::mm", 0, 100, "cpu_op"), Ev("aten::copy_", 200, 300, "cpu_op"),
              Ev("aten::add", 400, 700, "cpu_op")]
    events += launched("k_a", 10, 20, 30, 1)
    events.append(Ev("k_lost", 500, 510, "kernel", 99))  # gap 30-500, middle 265
    events += launched("k_b", 450, 600, 610, 2)  # gap 510-600, launched in aten::add
    tr = trace_of(events)
    assert tr.gaps() == [(470, 265), (90, 450)]
    assert dict(tr.idle_gaps()) == pytest.approx({"aten::copy_": 470e-9, "aten::add": 90e-9})


def test_innermost_holds_at_the_edges_and_between_spans():
    s = [("a", 0, 10), ("b", 2, 4), ("c", 4, 8), ("d", 20, 30)]
    # at 4 one span ends and the next starts: the time goes to the one starting
    assert spans.innermost(s, [0, 3, 4, 5, 9, 10, 11, 25, 31]) == [0, 1, 2, 2, 0, 0, None, 3,
                                                                   None]
    assert spans.innermost_parents(s) == [None, 0, 0, None]


def profiled_distill_round():
    """Host events of a small distillation round on the CPU, with its spans."""
    from raptor_tpu_torch.distill import post_training as pt
    from raptor_tpu_torch.policy import network

    cfg = pt.DistillConfig(rollout_length=8, aggregate_capacity=8, batch_size=4,
                           grad_steps_per_round=2, total_grad_steps=4)
    g = torch.Generator().manual_seed(1)
    agg = pt.aggregate_init(cfg, "cpu")
    pt.make_aggregate_add(cfg)(agg, pt.RoundData(torch.randn((8, 8, 22), generator=g),
                                                 torch.rand((8, 8, 4), generator=g),
                                                 torch.zeros((8, 8))), g)
    train_round, optim_init = pt.make_train_from_aggregate(cfg)
    student = network.init_params(torch.Generator().manual_seed(2))
    for layer in student.values():
        for leaf in layer.values():
            leaf.requires_grad_(True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        train_round(student, optim_init(student), agg, g)
    return list(prof.profiler.kineto_results.events())


def test_taking_the_spans_out_leaves_every_reading_as_without_them():
    """On CPU-profiled events with spans, plus a kernel a while after every
    third operator, each reading of the trace equals its value on the same
    events with the spans filtered out; put back among the host operators,
    the spans would change the idle gaps."""
    host = profiled_distill_round()
    assert any(e.name().startswith(spans.PREFIX) for e in host)
    ops = sorted((e for e in host if e.activity_type() == "cpu_op"), key=lambda e: e.start_ns())
    fake = []
    for corr, e in enumerate(ops[::3], start=10_000):
        lag = 3_000
        fake += launched(f"kernel_{corr % 4}", e.start_ns(), e.start_ns() + lag,
                         e.start_ns() + lag + 500, corr)
    with_spans = trace_of(host + fake, window_s=0.5)
    unrouted = trace_of(host + fake, window_s=0.5)
    unrouted.host_ops += unrouted.spans
    st = spans.SpanTrace(with_spans)
    plain = trace_of([e for e in host if not e.name().startswith(spans.PREFIX)] + fake,
                     window_s=0.5)

    def readings(tr):
        return (tr.launches(), tr.busy_s(), tr.idle_pct(), tr.kernel_seconds("kernel_1"),
                tr.top_device_ops(), tr.idle_gaps(), tr.host_ops)

    assert readings(with_spans) == readings(plain)
    assert unrouted.idle_gaps() != plain.idle_gaps()  # the spans would be the widest operators
    assert len(st.spans) == 2 * 5 and st.unattributed() == 0
    assert sum(s["launches"] for s in st.stats().values()) + st.outside_launches() == \
        with_spans.launches()


def fake_ctx(tr, traffic):
    return SimpleNamespace(device_trace=tr, stats={}, cell=SimpleNamespace(traffic=traffic))


def test_span_metrics_read_nothing_without_spans():
    events = launched("k", 10, 20, 30, 1)
    ctx = fake_ctx(trace_of(events), {"trace_steps": 3, "steps_per_call": 1})
    assert spans.host_ms(ctx, ["distill.forward"]) is None
    assert spans.launches(ctx, ["distill.forward"]) is None
    assert spans.host_ms(fake_ctx(None, {"trace_steps": 3}), ["env.reset"]) is None


def test_span_metrics_per_unit():
    events = [Ev("raptor.env.sample_population", 0, 1_000_000, "user_annotation"),
              Ev("raptor.env.reset", 1_000_000, 1_500_000, "user_annotation")]
    events += launched("k", 10, 20, 30, 1) + launched("k", 1_200_000, 1_300_000, 1_300_010, 2)
    ctx = fake_ctx(trace_of(events), {"trace_steps": 2})
    ctx.stats["program_spans"] = spans.SpanTrace(ctx.device_trace)
    names = ["env.sample_population", "env.reset"]
    assert spans.host_ms(ctx, names) == pytest.approx(0.75)
    assert spans.launches(ctx, names) == 1.0
    assert spans.of(ctx) is spans.of(ctx)  # read once


SPAN_METRICS = {
    "distill_train": {"distill_optimizer_host_ms"},
    "eval_population": {"eval_sampler_host_ms", "eval_pack_host_ms"},
    "eval_checkpoints": {"eval_pack_host_ms"},
}


@pytest.mark.parametrize("workload", sorted(SPAN_METRICS))
def test_traced_cells_report_their_span_metrics(workload):
    """On the CPU the host spans read; launches need a card's kernels."""
    ctx = tinycell.context(workload, trace=True, seconds=0.2)
    result = core.run_cell(ctx)
    assert result["correct"] is True
    assert SPAN_METRICS[workload] <= set(result["metrics"])
    assert all(result["metrics"][m]["value"] > 0 for m in SPAN_METRICS[workload])
    assert not any("launches" in m for m in result["metrics"])
    assert not any(op[0].startswith(spans.PREFIX) for op in ctx.device_trace.host_ops)
