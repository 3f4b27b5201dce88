"""Kernel launches of one teacher super-step: the device kernels in the
traced sub-window over its super-steps. A count that repeats exactly."""


def read(ctx):
    tr, traffic = ctx.device_trace, ctx.cell.traffic
    if tr is None or not tr.launches():
        return None
    return tr.launches() / (traffic["trace_steps"] * traffic["steps_per_call"])
