"""Kernel launches of one distillation gradient step's forward pass: the
device kernels whose launch falls in the program's `raptor.distill.forward`
span, over the traced steps. A count that repeats exactly."""

import spans


def read(ctx):
    return spans.launches(ctx, ["distill.forward"])
