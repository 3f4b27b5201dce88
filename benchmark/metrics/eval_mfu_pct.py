"""The whole evaluation's share of the card's FP32 peak: the eval kernel's
operations (env-steps run, from the reported mean episode lengths, times the
frozen per-step count) over the untraced window's span and the published
67 TFLOP/s."""

import opcount
import peaks


def read(ctx):
    w = ctx.window
    if not w.get("steps") or ctx.device.type != "cuda":
        return None
    return 100.0 * opcount.eval_kernel_flops(ctx.stats["window_env_steps"]) / w["span"] \
        / peaks.FP32_FLOPS
