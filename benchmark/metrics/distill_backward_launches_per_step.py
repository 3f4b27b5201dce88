"""Kernel launches of one distillation gradient step's backward pass: the
device kernels whose launch falls in the program's `raptor.distill.backward`
span (autograd's thread launches them while the span is open), over the
traced steps. A count that repeats exactly."""

import spans


def read(ctx):
    return spans.launches(ctx, ["distill.backward"])
