"""Plain reference of the SAC teacher farm: K teachers, one airframe each,
trained in lockstep from one seed, written on stacked [K, ...] float32
tensors in plain PyTorch.

A super-step rolls H env steps of the K x N envs (the actor's squashed
Gaussian action; the quadrotor of `reference/quad.py` with the per-step
disturbance draw, reward, termination, truncation at the episode length and
auto-reset to a fresh draw), writes the H rows into each teacher's replay
ring, then runs G SAC updates, each on B transitions of B / N whole time rows
drawn per teacher: twin critics against the target critics, the actor
through the updated critics, the entropy temperature, then Polyak targets,
with Adam (eps outside the square root) on each. The warm-up super-steps
roll uniform random actions and train nothing.

It imports nothing of the system under test. Every random number comes from
one `torch.Generator`, drawn in the order the farm documents (airframes,
actors, critics, initial states; then, a step, the action noise, the
disturbance, the fresh states; an update, the rows, the next-action noise,
the action noise), so the same seed gives the same teachers.
`precision="tf32"` computes every matmul of the networks in TF32: the
control.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from reference import quad
from reference.student import Adam
from reference.tf32 import matmul

LOG_STD_MIN, LOG_STD_MAX = -10.0, 2.0


def mlp_init(g, dims, k: int, final_scale: float = 1.0) -> List[Dict[str, torch.Tensor]]:
    layers = []
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        bound = (final_scale if i == len(dims) - 2 else 1.0) / math.sqrt(a)
        u = torch.rand((k, a, b), generator=g, device=g.device)
        layers.append({"w": -bound + u * (2.0 * bound), "b": torch.zeros((k, b), device=g.device)})
    return layers


def mlp(layers, x, precision):
    for i, layer in enumerate(layers):
        x = matmul(x, layer["w"], precision) + layer["b"][:, None, :]
        if i < len(layers) - 1:
            x = torch.relu(x)
    return x


def actor_sample(actor, obs, g, precision):
    """The squashed-Gaussian action and its log-probability (the tanh
    correction in its stable form)."""
    mu, log_std = mlp(actor, obs, precision).chunk(2, -1)
    log_std = torch.clamp(log_std, LOG_STD_MIN, LOG_STD_MAX)
    eps = torch.randn(mu.shape, generator=g, device=mu.device)
    pre = mu + torch.exp(log_std) * eps
    logp = torch.sum(-0.5 * eps**2 - log_std - 0.5 * math.log(2.0 * math.pi), -1) - torch.sum(
        2.0 * (math.log(2.0) - pre - torch.nn.functional.softplus(-2.0 * pre)), -1)
    return torch.tanh(pre), logp


def critics(critic, obs, action, precision):
    x = torch.cat([obs, action], -1)
    return mlp(critic["q1"], x, precision)[..., 0], mlp(critic["q2"], x, precision)[..., 0]


def leaves(tree) -> Dict[str, torch.Tensor]:
    """Named tensors of a network: "q1.0.w", ..."""
    if isinstance(tree, list):
        return {f"{i}.{k}": v for i, layer in enumerate(tree) for k, v in layer.items()}
    return {f"{net}.{name}": v for net, sub in tree.items() for name, v in leaves(sub).items()}


def rebuild(tree, flat: Dict[str, torch.Tensor], prefix=""):
    if isinstance(tree, list):
        return [{k: flat[f"{prefix}{i}.{k}"] for k in layer} for i, layer in enumerate(tree)]
    return {net: rebuild(sub, flat, f"{prefix}{net}.") for net, sub in tree.items()}


class Farm:
    """The farm replayed from `seed`. `cfg` holds the configuration's
    population, sac and env groups."""

    def __init__(self, seed: int, cfg: dict, device, precision: str = "float32"):
        pop, sac, env = cfg["population"], cfg["sac"], cfg["env"]
        self.pop, self.sac, self.env, self.precision = pop, sac, env, precision
        g = self.g = torch.Generator(device=device).manual_seed(seed)
        k, n = pop["n_teachers"], pop["envs_per_teacher"]
        self.k, self.n = k, n
        frames = quad.sample_airframes(g, k)
        self.p = quad.repeat_envs(frames, n)
        for key in ("disturbance_force_std", "disturbance_torque_std"):
            self.p[key] = torch.full((k * n,), cfg["randomization"][key], device=device)
        self.tail = quad.privileged_tail(self.p)
        obs_dim = 22 + self.tail.shape[-1]
        self.actor = mlp_init(g, [obs_dim, *sac["actor_hidden"], 8], k, final_scale=0.01)
        self.critic = {q: mlp_init(g, [obs_dim + 4, *sac["critic_hidden"], 1], k)
                       for q in ("q1", "q2")}
        self.target = rebuild(self.critic, {a: b.clone() for a, b in leaves(self.critic).items()})
        self.log_alpha = torch.full((k,), math.log(sac["init_alpha"]), device=device)
        self.opt = {"actor": Adam(leaves(self.actor)), "critic": Adam(leaves(self.critic)),
                    "alpha": Adam({"log_alpha": self.log_alpha})}
        self.s = quad.sample_states(self.p, g, env["init"])
        self.prev = torch.zeros((k * n, 4), device=device)
        self.t = torch.zeros(k * n, dtype=torch.int32, device=device)
        self.obs = self._observe(self.s, self.prev).reshape(k, n, -1)
        cap = pop["replay_capacity"]
        # obs, action, reward, next obs, terminated: [K, C, N, ...]
        self.ring = [torch.zeros((k, cap, n, *d), device=device)
                     for d in ((obs_dim,), (4,), (), (obs_dim,), ())]
        self.ptr = self.size = 0
        self.initial = {k: v.clone() for k, v in self.weights().items()}

    def weights(self) -> Dict[str, torch.Tensor]:
        return {**{f"actor.{a}": b for a, b in leaves(self.actor).items()},
                **{f"critic.{a}": b for a, b in leaves(self.critic).items()},
                **{f"target.{a}": b for a, b in leaves(self.target).items()},
                "log_alpha": self.log_alpha}

    def moments(self) -> Dict[str, torch.Tensor]:
        """Each optimizer's first moment by leaf."""
        return {f"{opt}.{name}": m for opt, adam in self.opt.items() for name, m in adam.m.items()}

    def _observe(self, s, prev):
        rot = quad.rotation_matrix(s["q"])
        return torch.cat([s["p"], rot, s["v"], s["w"], prev, self.tail], -1)

    def _env_step(self, action):
        """One step of every env with auto-reset: the replay row."""
        env, n_all = self.env, self.k * self.n
        a = torch.clamp(action.reshape(n_all, 4), -1.0, 1.0)
        ext_f, ext_t = (
            torch.randn((n_all, 3), generator=self.g, device=a.device) * self.p[key][:, None]
            for key in ("disturbance_force_std", "disturbance_torque_std"))
        s2 = quad.rk4_step(self.p, self.s, a, env["dt"], ext_f, ext_t)
        term = quad.terminated(s2, env["termination"])
        reward = quad.reward(self.p, s2, a, env["reward"]) \
            - env["reward"]["termination_penalty"] * term
        t_next = self.t + 1
        done = term | (t_next >= env["episode_length"])
        fresh = quad.sample_states(self.p, self.g, env["init"])
        keep = done[:, None]
        final_obs = self._observe(s2, a)
        self.s = {key: torch.where(keep, fresh[key], s2[key]) for key in s2}
        self.prev = torch.where(keep, torch.zeros_like(a), a)
        self.t = torch.where(done, torch.zeros_like(t_next), t_next)
        lead = (self.k, self.n)
        row = (self.obs, action, reward.reshape(lead), final_obs.reshape(*lead, -1),
               term.float().reshape(lead))
        self.obs = self._observe(self.s, self.prev).reshape(*lead, -1)
        return row

    def _collect(self, random_actions: bool):
        rows = []
        for _ in range(self.pop["rollout_length"]):
            with torch.no_grad():
                if random_actions:
                    action = torch.rand((self.k, self.n, 4), generator=self.g,
                                        device=self.obs.device) * 2.0 - 1.0
                else:
                    action = actor_sample(self.actor, self.obs, self.g, self.precision)[0]
                rows.append(self._env_step(action))
        h, cap = len(rows), self.ring[0].shape[1]
        idx = (self.ptr + torch.arange(h, device=self.obs.device)) % cap
        for i, arr in enumerate(self.ring):
            arr[:, idx] = torch.stack([r[i] for r in rows], 1)
        self.ptr, self.size = (self.ptr + h) % cap, min(self.size + h, cap)

    def _sample(self):
        rows = self.pop["batch_size"] // self.n
        idx = torch.randint(0, max(self.size, 1), (self.k, rows), generator=self.g,
                            device=self.obs.device)
        member = torch.arange(self.k, device=idx.device)[:, None]
        return [arr[member, idx].reshape(self.k, rows * self.n, *arr.shape[3:])
                for arr in self.ring]

    def _update(self):
        obs, action, reward, next_obs, done = self._sample()
        c, pr = self.sac, self.precision
        with torch.no_grad():
            alpha = torch.exp(self.log_alpha)
            next_a, next_logp = actor_sample(self.actor, next_obs, self.g, pr)
            tq1, tq2 = critics(self.target, next_obs, next_a, pr)
            target_q = reward + c["gamma"] * (1.0 - done) * (
                torch.minimum(tq1, tq2) - alpha[:, None] * next_logp)
        crit = {a: b.detach().requires_grad_(True) for a, b in leaves(self.critic).items()}
        q1, q2 = critics(rebuild(self.critic, crit), obs, action, pr)
        critic_loss = ((q1 - target_q) ** 2).mean(-1) + ((q2 - target_q) ** 2).mean(-1)
        grads = dict(zip(crit, torch.autograd.grad(critic_loss.sum(), list(crit.values()))))
        with torch.no_grad():
            self.critic = rebuild(self.critic, self.opt["critic"].step(
                {a: b.detach() for a, b in crit.items()}, grads, c["critic_lr"]))
        act = {a: b.detach().requires_grad_(True) for a, b in leaves(self.actor).items()}
        pi, logp = actor_sample(rebuild(self.actor, act), obs, self.g, pr)
        pq1, pq2 = critics(self.critic, obs, pi, pr)
        actor_loss = (alpha[:, None] * logp - torch.minimum(pq1, pq2)).mean(-1)
        grads = dict(zip(act, torch.autograd.grad(actor_loss.sum(), list(act.values()))))
        with torch.no_grad():
            self.actor = rebuild(self.actor, self.opt["actor"].step(
                {a: b.detach() for a, b in act.items()}, grads, c["actor_lr"]))
        log_alpha = self.log_alpha.detach().requires_grad_(True)
        target_entropy = c["target_entropy_per_dim"] * 4
        alpha_loss = -(torch.exp(log_alpha)[:, None] * (logp.detach() + target_entropy)).mean(-1)
        (grad,) = torch.autograd.grad(alpha_loss.sum(), [log_alpha])
        with torch.no_grad():
            self.log_alpha = self.opt["alpha"].step(
                {"log_alpha": log_alpha.detach()}, {"log_alpha": grad}, c["alpha_lr"])["log_alpha"]
            tau = c["tau"]
            self.target = rebuild(self.target, {
                a: (1.0 - tau) * b + tau * leaves(self.critic)[a]
                for a, b in leaves(self.target).items()})
        return torch.stack([critic_loss.detach(), actor_loss.detach(), alpha_loss.detach()])

    def warmup(self):
        self._collect(random_actions=True)

    def super_step(self):
        """Collect, then train; the losses [3, K] of the last update."""
        self._collect(random_actions=False)
        for _ in range(self.pop["gradient_steps"]):
            losses = self._update()
        return losses
