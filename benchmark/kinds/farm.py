"""Kind `farm`: the SAC teacher farm of the port, the population trainer's
call `distill.population.make_population_multi_step(env, run_cfg, sac_cfg,
n)` again and again on one wave.

Set-up builds the wave from the seed the way `apps/pre_training.py
--population K` does (`sample_teacher_airframes`, `population_init`, the
configuration's random warm-up super-steps), then drives that one object
through its first `check_steps` calls by the window's own call and keeps
what the check needs: each call's losses, each optimizer's first moment
after the first call, and the weights after the last. The window goes on
with the same object. One unit of work is one env-step of one env.

The check (after the window, with the program's state freed) replays the
wave from the same seed with the plain reference (`reference/sac.py`) and
compares, teacher by teacher: each call's critic, actor and temperature
losses, the first moments after the first call and the weights' change
after the checked calls, each of the last two by the teacher's worst leaf.
Each number is the median teacher's: the teachers are independent learners,
and a few of them, whose flights tumble, part from the reference by
rounding alone over hundreds of steps (PERF.md).
"""

from __future__ import annotations

import statistics
import sys

import torch

import compare
from core import derive_seed
from reference import sac as ref


def program_leaves(sac_state):
    """The program's learner by the reference's leaf names."""
    out = {"log_alpha": sac_state.log_alpha}
    for net, tree in (("actor", sac_state.actor), ("critic", sac_state.critic),
                      ("target", sac_state.target_critic)):
        nets = tree if "layers" not in tree else {"": tree}
        for q, sub in nets.items():
            for i, layer in enumerate(sub["layers"]):
                for k, v in layer.items():
                    out[f"{net}.{q + '.' if q else ''}{i}.{k}"] = v
    return out


def program_moments(sac_state):
    """Each optimizer's first moment, by the reference's leaf names."""
    names = program_leaves(sac_state)
    by_tensor = {id(v): k for k, v in names.items()}
    out = {}
    for opt, adam in (("actor", sac_state.actor_opt), ("critic", sac_state.critic_opt),
                      ("alpha", sac_state.alpha_opt)):
        for p in (p for g in adam.param_groups for p in g["params"]):
            name = by_tensor[id(p)]
            short = name.split(".", 1)[1] if "." in name else name
            out[f"{opt}.{short}"] = adam.state[p]["exp_avg"].detach().clone()
    return out


def snapshot(tensors):
    return {k: v.detach().clone() for k, v in tensors.items()}


class Run:
    synchronous = False

    def __init__(self, ctx):
        from raptor_tpu_torch.distill import population
        from raptor_tpu_torch.env import L2F
        from raptor_tpu_torch.env.types import (EnvConfig, InitConfig, RewardConfig,
                                                TerminationConfig)
        from raptor_tpu_torch.rl.sac import SACConfig

        self.ctx, dev = ctx, ctx.device
        cfg, traffic = ctx.cell.config, ctx.cell.traffic
        self.cfg, self.traffic = cfg, traffic
        e = cfg["env"]
        env = L2F(EnvConfig(dt=e["dt"], episode_length=e["episode_length"],
                            init=InitConfig(**e["init"]), reward=RewardConfig(**e["reward"]),
                            termination=TerminationConfig(**e["termination"])))
        sac_fields = dict(cfg["sac"], actor_hidden=tuple(cfg["sac"]["actor_hidden"]),
                          critic_hidden=tuple(cfg["sac"]["critic_hidden"]))
        sac_cfg = SACConfig(**sac_fields)
        pop_cfg = population.PopulationConfig(**cfg["population"])
        self.seed = derive_seed(ctx.seed, "farm")
        gen = torch.Generator(device=dev).manual_seed(self.seed)
        airframes = population.sample_teacher_airframes(gen, pop_cfg.n_teachers)
        states, env_params, run_cfg = population.population_init(
            gen, env, airframes, pop_cfg, sac_cfg)
        self.w0 = snapshot(program_leaves(states.sac))
        warmup = population.make_population_warmup(env, run_cfg)
        for _ in range(pop_cfg.warmup_super_steps):
            states = warmup(states, env_params)
        multi = population.make_population_multi_step(env, run_cfg, sac_cfg,
                                                      traffic["steps_per_call"])
        self.program = dict(states=states, env_params=env_params, multi=multi)
        self.units = float(traffic["steps_per_call"] * run_cfg.rollout_length
                           * run_cfg.n_envs * pop_cfg.n_teachers)
        self.losses = []
        for i in range(traffic["check_steps"]):
            self.losses.append(self._call())
            if i == 0:
                self.m1 = program_moments(self.program["states"].sac)
        self.w_after = snapshot(program_leaves(self.program["states"].sac))
        self.window_losses = []

    def _call(self):
        p = self.program
        p["states"], metrics = p["multi"](p["states"], p["env_params"])
        return torch.stack([metrics.critic_loss, metrics.actor_loss, metrics.alpha_loss]).detach()

    def step(self, i, traced=False):
        self.window_losses.append(self._call())
        return self.units

    def sync(self):
        if self.ctx.device.type == "cuda":
            torch.cuda.synchronize(self.ctx.device)

    def probe(self):
        pass

    def failed(self):
        """Calls whose losses are not all finite."""
        return sum(int(not torch.isfinite(x).all()) for x in self.window_losses)

    def _replay(self, precision):
        """(each checked call's losses [3, K], first moments after the first
        call, weights after the last, initial weights) of the reference."""
        farm = ref.Farm(self.seed, self.cfg, self.ctx.device, precision)
        for _ in range(self.cfg["population"]["warmup_super_steps"]):
            farm.warmup()
        losses, m1 = [], None
        for i in range(self.traffic["check_steps"]):
            for _ in range(self.traffic["steps_per_call"]):
                last = farm.super_step()
            losses.append(last)
            if i == 0:
                m1 = snapshot(farm.moments())
        return losses, m1, farm.weights(), farm.initial

    def check(self, which=("program",)):
        self.program = None  # the program's state is freed before the reference runs
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()
        losses_r, m1_r, w_r, w0_r = self._replay("float32")
        moving = compare.moving_leaves(m1_r)
        moving_w = [k for k in w_r if moment_of(k) in moving]
        delta_r = {k: w_r[k] - w0_r[k] for k in moving_w}
        print(f"farm check: left out of the change, their gradient under 1/1000 of the median "
              f"leaf's: {sorted(set(w_r) - set(moving_w))}", file=sys.stderr)
        out = {}
        for who in which:
            if who == "program":
                losses, m1, w_end, w0 = self.losses, self.m1, self.w_after, self.w0
            else:
                losses, m1, w_end, w0 = self._replay(who)
            out[who] = {
                "loss_gap": max(median_gap(a, b) for la, lb in zip(losses, losses_r)
                                for a, b in zip(la, lb)),
                "moment1_gap": compare.median_member_gap(m1, m1_r, list(m1_r)),
                "change_gap": compare.median_member_gap(
                    {k: w_end[k] - w0[k] for k in moving_w}, delta_r, moving_w),
            }
        return out["program"] if which == ("program",) else out


def moment_of(weight: str) -> str:
    """The optimizer moment that moves a weight (a target critic's leaf
    follows its critic's)."""
    if weight == "log_alpha":
        return "alpha.log_alpha"
    net, rest = weight.split(".", 1)
    return f"{'critic' if net == 'target' else net}.{rest}"


def median_gap(value: torch.Tensor, ref_value: torch.Tensor) -> float:
    """The median teacher's |value - ref| / max(|ref|, the median |ref|)."""
    floor = float(ref_value.abs().median())
    gaps = [compare.rel_gap(float(a), float(b), floor) for a, b in zip(value, ref_value)]
    return statistics.median(gaps)


def setup(ctx):
    return Run(ctx)
