"""Kernel launches of one distillation gradient step: the device kernels in
the traced sub-window over its steps. A count that repeats exactly."""


def read(ctx):
    tr, steps = ctx.device_trace, ctx.cell.traffic["trace_steps"]
    if tr is None or not tr.launches():
        return None
    return tr.launches() / steps
