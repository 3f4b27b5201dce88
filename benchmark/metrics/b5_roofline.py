"""The BPTT kernels' share of their roofline: the least time the card could
take for the traced gradient steps' forward and backward passes (the larger
of their operations over the FP32 peak and their bytes over the HBM peak)
over the device time of the kernels whose name holds `bptt_` in the trace
(B5's forward, backward and fixed-order gradient sum). Operations and bytes
are the frozen counts from the configuration's shapes
(`opcount.bptt_flops`, `opcount.bptt_bytes`) times the traced steps."""

import opcount
import peaks
import spans

KERNEL = "bptt_"


def read(ctx):
    tr = ctx.device_trace
    if tr is None:
        return None
    seconds, launches = tr.kernel_seconds(KERNEL)
    if not launches or seconds <= 0:
        return None
    cfg, policy = ctx.cell.config["distill_config"], ctx.cell.config["policy"]
    shape = (cfg["batch_size"], cfg["rollout_length"], policy["obs_dim"], cfg["student_hidden"],
             policy["action_dim"])
    steps = spans.units(ctx)
    least, _ = peaks.roofline_seconds(steps * opcount.bptt_flops(*shape),
                                      steps * opcount.bptt_bytes(*shape))
    return 100.0 * least / seconds
