"""Host milliseconds of one request's airframe sampler and initial-state
reset inside the request: the program's `raptor.env.sample_population` and
`raptor.env.reset` spans over the traced requests, not synchronized (the
host's enqueue time, which holds the card idle). Unlike `eval_sample_ms` it
leaves out the harness's repeat over the envs and the closing synchronize."""

import spans


def read(ctx):
    return spans.host_ms(ctx, ["env.sample_population", "env.reset"])
