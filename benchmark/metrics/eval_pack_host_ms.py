"""Host milliseconds of one request's packing for the eval kernel: the
program's `raptor.ops.eval.pack` spans (the policy flattened and moved to the
device, the population and the states turned into SoA rows and moved) over
the traced requests."""

import spans


def read(ctx):
    return spans.host_ms(ctx, ["ops.eval.pack"])
