"""Kernel launches of one request's airframe sampler and initial-state
reset: the device kernels whose launch falls in the program's
`raptor.env.sample_population` or `raptor.env.reset` span, over the traced
requests. A count that repeats exactly."""

import spans


def read(ctx):
    return spans.launches(ctx, ["env.sample_population", "env.reset"])
