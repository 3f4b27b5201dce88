"""Host milliseconds of one distillation gradient step's backward pass: the
program's `raptor.distill.backward` span (`loss.backward()`, autograd's
engine over the unrolled loop) over the traced steps."""

import spans


def read(ctx):
    return spans.host_ms(ctx, ["distill.backward"])
