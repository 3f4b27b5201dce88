"""The eval kernel's share of its roofline: the least time the card could
take for the traced requests (the larger of their operations over the FP32
peak and their bytes over the HBM peak) over the device time of the kernels
named `eval_kernel` in the trace. Operations are the env-steps the requests
ran (the sum of the episode lengths) times the frozen per-step count;
bytes are each input read once and each output written once."""

import opcount
import peaks

KERNEL = "eval_kernel"


def read(ctx):
    tr = ctx.device_trace
    if tr is None:
        return None
    seconds, launches = tr.kernel_seconds(KERNEL)
    if not launches or seconds <= 0:
        return None
    ev = ctx.cell.config["eval"]
    n = ev["n_airframes"] * ev["envs_per_airframe"]
    flops = opcount.eval_kernel_flops(ctx.stats["traced_env_steps"])
    nbytes = launches * opcount.eval_kernel_bytes(n, ctx.cell.config["policy"]["n_weights"])
    least, _ = peaks.roofline_seconds(flops, nbytes)  # bound by operations at these shapes
    return 100.0 * least / seconds
