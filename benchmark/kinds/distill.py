"""Kind `distill`: the DAgger distillation step of the port, the train round
of `distill.post_training.make_train_from_aggregate(cfg)` called again and
again on a full aggregate.

Set-up makes, from the seed and on the card, the aggregate's sequences
(policy observations, teacher labels, episode restarts) and the student's
initial weights, and hands them to the program: the sequences through the
program's own `Aggregate` (`aggregate_init`, `make_aggregate_add`), the
weights as the student's leaves. The program's optimizer and learning-rate
schedule are its own, built from the configuration's `DistillConfig`. The
set-up then drives that one object through its first `check_steps` calls of
the window's own call (`steps_per_call` gradient steps each), and keeps what
the check needs: the losses, the optimizer's first moment after the first
call (the first gradient, at one step a call), the weights after the last
call, and the state of the minibatch generator before each. The window goes
on with the same objects. One unit of work is one gradient step.

The check (after the window, with the program's state freed) runs the plain
reference (`reference/student.py`) over the same minibatches from the same
initial weights and compares: each step's loss, the first gradient by the
worst leaf, and the weights' change after the checked steps by the worst
leaf.
"""

from __future__ import annotations

import sys

import torch

import compare
from core import derive_seed
from reference import student as ref

OBS_DIM, ACT_DIM = 22, 4


def distill_config(ctx):
    """The program's DistillConfig of the configuration, with the traffic's
    gradient steps a call."""
    from raptor_tpu_torch.distill.post_training import DistillConfig

    fields = dict(ctx.cell.config["distill_config"])
    fields["grad_steps_per_round"] = ctx.cell.traffic["steps_per_call"]
    return DistillConfig(**fields)


def make_sequences(g: torch.Generator, t_len: int, cap: int, spec: dict):
    """The aggregate's content in bfloat16, drawn in a few large calls:
    observations N(0, scale) by channel, labels uniform in [-1, 1], episode
    restarts at `reset_rate` a step and after the last step."""
    dev = g.device
    obs = torch.randn((t_len, cap, OBS_DIM), generator=g, device=dev, dtype=torch.bfloat16)
    obs.mul_(torch.tensor(spec["obs_scale"], device=dev, dtype=torch.bfloat16))
    label = torch.rand((t_len, cap, ACT_DIM), generator=g, device=dev, dtype=torch.bfloat16)
    label.mul_(2.0).sub_(1.0)
    reset = torch.rand((t_len, cap), generator=g, device=dev) < spec["reset_rate"]
    reset[-1] = True
    return obs, label, reset.to(torch.bfloat16)


def to_program_student(weights):
    """Flat reference names ("layer/name") -> the program's nested dict of
    leaves that record gradients."""
    out = {}
    for name, t in weights.items():
        layer, leaf = name.split("/")
        out.setdefault(layer, {})[leaf] = t.clone().requires_grad_(True)
    return out


def flat(student):
    return {f"{layer}/{k}": v.detach().clone() for layer, d in student.items()
            for k, v in d.items()}


def first_moment(opt, student):
    """Adam's first moment over (1 - beta1), by leaf: after one step, the
    gradient of that step as the program's Adam got it (m_1 = (1 - beta1) g_1)."""
    adam = next(o for o in opt if isinstance(o, torch.optim.Optimizer))
    beta1 = adam.param_groups[0]["betas"][0]
    return {f"{layer}/{k}": adam.state[v]["exp_avg"].detach().clone() / (1.0 - beta1)
            for layer, d in student.items() for k, v in d.items()}


class Run:
    synchronous = False

    def __init__(self, ctx):
        from raptor_tpu_torch.distill import post_training as pt

        self.ctx, dev = ctx, ctx.device
        cfg = self.cfg = distill_config(ctx)
        traffic = ctx.cell.traffic
        hidden = cfg.student_hidden
        self.ref_cfg = {k: getattr(cfg, k) for k in
                        ("learning_rate", "total_grad_steps", "lr_warmup_frac", "lr_final_scale")}
        data_gen = torch.Generator(device=dev).manual_seed(derive_seed(ctx.seed, "aggregate"))
        self.data = make_sequences(data_gen, cfg.rollout_length, cfg.aggregate_capacity,
                                   traffic["aggregate"])
        self.w0 = ref.init_weights(
            torch.Generator(device=dev).manual_seed(derive_seed(ctx.seed, "student")), hidden)

        agg = pt.aggregate_init(cfg, dev)
        pt.make_aggregate_add(cfg)(agg, pt.RoundData(*self.data), torch.Generator(device=dev))
        train_round, optim_init = pt.make_train_from_aggregate(cfg)
        student = to_program_student(self.w0)
        opt = optim_init(student)
        gen = torch.Generator(device=dev).manual_seed(derive_seed(ctx.seed, "minibatches"))
        self.program = dict(agg=agg, train_round=train_round, student=student, opt=opt, gen=gen)

        self.gen_states, losses = [], []
        for i in range(traffic["check_steps"]):
            self.gen_states.append(gen.get_state())
            losses.append(self._call())
            if i == 0:
                self.g1 = first_moment(opt, student)
        self.losses = [float(x) for x in torch.cat(losses)]  # every step of the checked calls
        self.w_after = flat(student)
        self.window_losses = []

    def _call(self):
        p = self.program
        p["student"], p["opt"], losses = p["train_round"](
            p["student"], p["opt"], p["agg"], p["gen"], None)
        return losses.detach()

    def step(self, i, traced=False):
        self.window_losses.append(self._call())
        return float(self.cfg.grad_steps_per_round)

    def sync(self):
        if self.ctx.device.type == "cuda":
            torch.cuda.synchronize(self.ctx.device)

    def probe(self):
        pass

    def failed(self):
        if not self.window_losses:
            return 0
        return int((~torch.isfinite(torch.cat(self.window_losses))).sum())

    def _batches(self):
        """The minibatches of the checked steps, drawn again from the
        generator's state before each checked call as the program draws
        them (batch_size uniform columns of the filled aggregate a step),
        gathered and widened to float32."""
        obs, label, reset = self.data
        out = []
        for state in self.gen_states:
            g = torch.Generator(device=self.ctx.device)
            g.set_state(state)
            for _ in range(self.cfg.grad_steps_per_round):
                idx = torch.randint(0, obs.shape[1], (self.cfg.batch_size,), generator=g,
                                    device=self.ctx.device)
                out.append((obs[:, idx].float(), label[:, idx].float(), reset[:, idx].float()))
        return out

    def check(self, which=("program",)):
        """{name: number} for the program (and, for the control reading,
        {who: {name: number}} for each of `which`)."""
        self.program = None  # the program's state is freed before the reference runs
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()
        batches, per_call = self._batches(), self.cfg.grad_steps_per_round
        losses_r, g1_r, w_r = ref.train_steps(self.w0, batches, self.ref_cfg,
                                              moment_after=per_call)
        moving = compare.moving_leaves(g1_r)
        delta_r = {k: w_r[k] - self.w0[k] for k in moving}
        print(f"distill check: left out of the change, their gradient under 1/1000 of the "
              f"median leaf's: {sorted(set(w_r) - set(moving))}", file=sys.stderr)
        out = {}
        for who in which:
            if who == "program":
                losses, g1, w_end = self.losses, self.g1, self.w_after
            else:
                losses, g1, w_end = ref.train_steps(self.w0, batches, self.ref_cfg, who,
                                                    moment_after=per_call)
            out[who] = {
                "loss_gap": max(compare.rel_gap(a, b) for a, b in zip(losses, losses_r)),
                "grad1_gap": compare.worst_leaf_norm_gap(g1, g1_r),
                "change_gap": compare.worst_leaf_norm_gap(
                    {k: w_end[k] - self.w0[k] for k in moving}, delta_r, moving),
            }
        return out["program"] if which == ("program",) else out


def setup(ctx):
    return Run(ctx)
