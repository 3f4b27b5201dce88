"""Share of the traced sub-window of distillation steps in which no kernel,
copy or set ran on the card."""


def read(ctx):
    return None if ctx.device_trace is None else ctx.device_trace.idle_pct()
