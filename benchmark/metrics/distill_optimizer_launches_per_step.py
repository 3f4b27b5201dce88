"""Kernel launches of one distillation gradient step's optimizer: the
device kernels whose launch falls in the program's `raptor.distill.optimizer`
span (the foreach Adam's kernels), over the traced steps. A count that
repeats exactly; an optimizer inside the step's graph replay makes it 0."""

import spans


def read(ctx):
    return spans.launches(ctx, ["distill.optimizer"])
