"""Host milliseconds of one request's airframe sampler, env repeat and
initial-state reset, ended by a synchronize: the median over the traffic's
probe requests, made after the traced sub-window."""


def read(ctx):
    return ctx.stats.get("eval_sample_ms")
