"""Kind `eval`: closed-loop evaluation of a student checkpoint over a
randomized population, one evaluation a request, in a closed loop, as
`apps/evaluate.py --fused --eval-parity-init` runs it: airframes from
`env.randomization.sample_population`, each repeated over its envs, initial
states from `L2F.reset`, whole episodes in the eval kernel
(`ops.eval.fused_policy_eval`), and `rl.evaluation.summarize` read back to
the host, which ends the request.

The traffic says whether each request draws a new population from its own
seed (`"population": "fresh"`, multi-seed scoring) or all requests share one
drawn in set-up (`"fixed"`, comparing checkpoints), and which committed
students the requests take in turn. One unit of work is one episode.

The check runs the plain reference (`reference/quad.py`) on a sample of the
requests, drawn from the seed: it draws their populations again from the
same seeds, flies the same student over them, and compares each env's
alive flag, length, return and final state, and the summary. A population
drawn wrong shows in these: the reference flies its own draws.
"""

from __future__ import annotations

import random
import statistics
import time

import numpy as np
import torch

import compare
from core import ROOT, derive_seed
from reference import quad as ref


def load_weights(path: str, device) -> dict:
    """A committed student (`.npz`, "<layer>/<name>" keys) read with numpy."""
    with np.load(path) as z:
        return {k: torch.as_tensor(z[k], dtype=torch.float32, device=device)
                for k in z.files if not k.startswith("example/")}


def to_program_policy(weights: dict) -> dict:
    out = {}
    for name, t in weights.items():
        layer, leaf = name.split("/")
        out.setdefault(layer, {})[leaf] = t.clone()
    return out


class Run:
    synchronous = True

    def __init__(self, ctx):
        from raptor_tpu_torch.env import L2F
        from raptor_tpu_torch.env.types import (EnvConfig, InitConfig, RewardConfig,
                                                TerminationConfig)

        self.ctx, dev = ctx, ctx.device
        ev, traffic = ctx.cell.config["eval"], ctx.cell.traffic
        self.ev, self.traffic = ev, traffic
        self.n_air, self.per = ev["n_airframes"], ev["envs_per_airframe"]
        self.n = self.n_air * self.per
        self.env = L2F(EnvConfig(
            dt=ev["dt"], episode_length=ev["episode_length"], init=InitConfig(**ev["init"]),
            reward=RewardConfig(**ev["reward"]),
            termination=TerminationConfig(**ev["termination"])))
        self.weights = [load_weights(f"{ROOT}/{ctx.cell.config['students'][s]}", dev)
                        for s in traffic["students"]]
        self.policies = [to_program_policy(w) for w in self.weights]
        self.fixed = None
        if traffic["population"] == "fixed":
            self.fixed = self._population(*self._seeds("fixed"))
        rng = random.Random(derive_seed(ctx.seed, "check"))
        self.check_ids = sorted(rng.sample(range(traffic["check_range"]),
                                           traffic["check_requests"]))
        self.kept, self.summaries = {}, []
        self.traced_env_steps, self.sample_ms = 0.0, []
        for i in range(traffic["warmup_requests"]):  # loads the kernels; every shape of the window
            self._request(-1 - i)

    def _seeds(self, i):
        """(population seed, reset seed) of request i; every request of a
        fixed population has the set-up's."""
        tag = "fixed" if self.traffic["population"] == "fixed" else i
        return (derive_seed(self.ctx.seed, "population", tag),
                derive_seed(self.ctx.seed, "reset", tag))

    def _population(self, s_pop, s_reset):
        from raptor_tpu_torch.env.randomization import sample_population
        from raptor_tpu_torch.env.types import tree_map

        dev = self.ctx.device
        frames = sample_population(torch.Generator(device=dev).manual_seed(s_pop), self.n_air)
        stacked = tree_map(lambda x: x.repeat_interleave(self.per, 0), frames)
        es, _ = self.env.reset(stacked, torch.Generator(device=dev).manual_seed(s_reset))
        return stacked, es.dynamics

    def _request(self, i):
        from raptor_tpu_torch.ops import eval as ops_eval
        from raptor_tpu_torch.rl import evaluation

        seeds = self._seeds(i)
        params, state = self.fixed if self.fixed is not None else self._population(*seeds)
        k = i % len(self.policies)
        term = self.env.config.termination
        final, alive, length, ret = ops_eval.fused_policy_eval(
            self.policies[k], params, state, self.env.EPISODE_LENGTH, dt=self.env.config.dt,
            pos_bound=term.position_bound, angvel_bound=term.angular_velocity_bound,
            reward_config=self.env.config.reward, linvel_bound=term.linear_velocity_bound,
            device=self.ctx.device)
        summary = torch.stack(list(evaluation.summarize(ret, length, alive))).tolist()
        if i in self.check_ids:
            self.kept[i] = dict(student=k, seeds=seeds, final=final, alive=alive, length=length,
                                ret=ret, summary=summary)
        return summary

    def step(self, i, traced=False):
        summary = self._request(i)
        self.summaries.append(summary)
        if traced:
            self.traced_env_steps += summary[2] * self.n
        return float(self.n)

    def sync(self):
        if self.ctx.device.type == "cuda":
            torch.cuda.synchronize(self.ctx.device)

    def probe(self):
        """Host time of the sampler and the reset, ended by a synchronize,
        over the traffic's probe requests (fresh populations only)."""
        self.ctx.stats["window_env_steps"] = self.window_env_steps()
        self.ctx.stats["traced_env_steps"] = self.traced_env_steps
        if self.fixed is not None:
            return
        for j in range(self.traffic["probe_requests"]):
            t0 = time.perf_counter()
            self._population(*self._seeds(10**9 + j))
            self.sync()
            self.sample_ms.append(1000.0 * (time.perf_counter() - t0))
        self.ctx.stats["eval_sample_ms"] = statistics.median(self.sample_ms)

    def failed(self):
        """Requests whose summary is not finite."""
        return sum(not all(np.isfinite(s)) for s in self.summaries)

    def window_env_steps(self):
        return sum(s[2] for s in self.summaries[:self.ctx.window["steps"]]) * self.n

    def _reference_inputs(self, kept):
        dev = self.ctx.device
        s_pop, s_reset = kept["seeds"]
        frames = ref.sample_airframes(torch.Generator(device=dev).manual_seed(s_pop), self.n_air)
        p = ref.repeat_envs(frames, self.per)
        s = ref.sample_states(p, torch.Generator(device=dev).manual_seed(s_reset),
                              self.ev["init"])
        return p, s

    def check(self, which=("program",)):
        """Each number is the worst over the checked requests."""
        due = [i for i in self.check_ids if i in self.kept]
        kept = {i: self.kept[i] for i in due}
        self.kept = self.fixed = self.policies = None  # the program's state is freed
        out = {who: {} for who in which}
        for k in kept.values():
            p, s = self._reference_inputs(k)
            w, t_len = self.weights[k["student"]], self.ev["episode_length"]
            reference = ref.closed_loop(w, p, s, t_len, self.ev)
            for who in which:
                if who == "program":
                    f = k["final"]
                    got = ({"p": f.position, "q": f.orientation, "v": f.linear_velocity,
                            "w": f.angular_velocity, "rpm": f.rpm},
                           k["alive"] != 0, k["length"], k["ret"])
                    nums = outcome_numbers(got, k["summary"], reference)
                else:
                    got = ref.closed_loop(w, p, s, t_len, self.ev, who)
                    summary = ref.summarize(got[3], got[2], got[1]).tolist()
                    nums = outcome_numbers(got, summary, reference)
                for name, v in nums.items():  # the worst request's; a NaN stays
                    prev = out[who].get(name, 0.0)
                    out[who][name] = v if v != v or v > prev else prev
        if not due:
            out = {who: {"checked_requests": float("inf")} for who in which}
        return out["program"] if which == ("program",) else out


STATE_KEYS = ("p", "q", "v", "w", "rpm")


def outcome_numbers(got, summary, reference) -> dict:
    """The numbers of one request: `got` and `reference` are (final state,
    alive, length, return) by env, `summary` the five statistics reported."""
    final, alive, length, ret = got
    r_final, r_alive, r_length, r_ret = reference
    same = (alive == r_alive) & (length == r_length)
    rows = torch.cat([final[k] for k in STATE_KEYS], -1)
    r_rows = torch.cat([r_final[k] for k in STATE_KEYS], -1)
    ret_err = (ret - r_ret).abs() / torch.clamp(r_ret.abs(), min=1.0)
    state_err = (rows - r_rows).abs().amax(-1)
    r_summary = ref.summarize(r_ret, r_length, r_alive).tolist()
    return {
        "mismatch_share": float(1.0 - same.float().mean()),
        "return_err_p50": float(ret_err[same].median()) if same.any() else float("inf"),
        "state_err_p50": float(state_err[same].median()) if same.any() else float("inf"),
        "summary_gap": max(compare.rel_gap(a, b, 1.0) for a, b in zip(summary, r_summary)),
    }


def setup(ctx):
    return Run(ctx)
