"""Host milliseconds of one distillation gradient step's optimizer: the
program's `raptor.distill.optimizer` span (the eager Adam step, the
learning-rate schedule's step and `zero_grad`, after the step's graph
replay) over the traced steps. The host's enqueue time, not synchronized:
the card waits on it."""

import spans


def read(ctx):
    return spans.host_ms(ctx, ["distill.optimizer"])
