"""Host milliseconds of one distillation gradient step's forward pass: the
program's `raptor.distill.forward` span (`bptt_loss` over the T-step loop of
`bptt_actions`, recorded under autograd) over the traced steps. The host's
enqueue time, not synchronized: the card waits on it."""

import spans


def read(ctx):
    return spans.host_ms(ctx, ["distill.forward"])
