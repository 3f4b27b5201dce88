"""The whole distillation step's share of the card's FP32 peak: the step's
operations counted from its shapes (`opcount.distill_step_flops`) times the
steps of the untraced window, over the window's span and the published
67 TFLOP/s."""

import opcount
import peaks


def read(ctx):
    w, cfg = ctx.window, ctx.cell.config["distill_config"]
    if not w.get("steps") or ctx.device.type != "cuda":
        return None
    flops = opcount.distill_step_flops(cfg["batch_size"], cfg["rollout_length"],
                                       hidden=cfg["student_hidden"])
    return 100.0 * flops * w["units"] / w["span"] / peaks.FP32_FLOPS
