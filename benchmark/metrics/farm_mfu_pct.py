"""The whole teacher super-step's share of the card's FP32 peak: the
operations counted from the configuration's shapes
(`opcount.farm_super_step_flops`: env steps with the actor's action, and the
SAC updates forward and backward) times the super-steps of the untraced
window, over the window's span and the published 67 TFLOP/s."""

import opcount
import peaks

OBS_DIM = 31  # the policy's 22 and the 9-value privileged tail


def read(ctx):
    w, traffic = ctx.window, ctx.cell.traffic
    if not w.get("steps") or ctx.device.type != "cuda":
        return None
    p, sac = ctx.cell.config["population"], ctx.cell.config["sac"]
    flops = opcount.farm_super_step_flops(
        p["n_teachers"], p["envs_per_teacher"], p["rollout_length"], p["gradient_steps"],
        p["batch_size"], OBS_DIM, hidden=tuple(sac["actor_hidden"]))
    return 100.0 * flops * w["steps"] * traffic["steps_per_call"] / w["span"] / peaks.FP32_FLOPS
