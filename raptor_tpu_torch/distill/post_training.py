"""Post-training: distill a teacher population into the recurrent foundation
policy by round-based on-policy distillation (DAgger).

Counterpart of `raptor_tpu/distill/post_training.py`:

  round:
    collect: roll the student (beta-mixed with the teachers early on) across
             the airframe population; the teachers label every visited state
             with their (privileged-observation) mean action
    train:   supervised BPTT over the collected [T]-step sequences, MSE of
             student action against teacher label
    eval / checkpoint: through `round_hook`

The student's hidden state restarts at its learned initial state exactly where
an env auto-resets, and the same reset masks drive the hidden re-injection
during BPTT.

Where the JAX package jits and scans, this runs eagerly: `make_collect` is a
Python loop of T env steps. The BPTT (`bptt_actions`) is one forward and one
backward CUDA kernel on a card (`ops.bptt`, a `torch.autograd.Function`), and
`torch.autograd` over `policy.network.apply_step` unrolled over T on the CPU.
On a card the loss and gradients of a step of `make_train_from_aggregate`
are one CUDA graph replay (`utils.graphs`: gather, BPTT and its gradient),
after an eager draw of its minibatch and before an eager Adam step.
The student's parameters are leaf tensors with `requires_grad`, updated in
place by `torch.optim.Adam`; the aggregate is updated in place too. Randomness comes from one explicit
`torch.Generator` on the data's device, so the random streams differ from the
JAX package's threefry keys. `fused_collect_round` collects a beta == 0 round
through the collect kernel (`ops/collect.py`) and one batched relabel pass.

Over several devices (one process a device, `parallel/`), each process
collects its block of the ('pop', 'env') layout with `make_collect` (its
block of the teachers and of each teacher's envs, `parallel.mesh.
distill_block`), keeps its block of the aggregate's columns
(`parallel.mesh.shard_distill_config`), and trains the replicated student on
its share of each minibatch with the gradients averaged over the group
(`make_train_from_aggregate(cfg, group)`). `distill()` itself runs on one
device, as the JAX package's does.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, List, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from raptor_tpu_torch.distill.population import broadcast_airframe_to_envs, flatten_envs
from raptor_tpu_torch.env.quad import L2F
from raptor_tpu_torch.env.recovery import recovery_action, tilt_angle
from raptor_tpu_torch.env.types import POLICY_OBS_DIM, DynamicsParams, tree_map
from raptor_tpu_torch.ops import bptt as ops_bptt
from raptor_tpu_torch.policy import network as student_net
from raptor_tpu_torch.rl import networks
from raptor_tpu_torch.rl.sac import average_over
from raptor_tpu_torch.utils import graphs
from raptor_tpu_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class DistillConfig:
    envs_per_teacher: int = 8
    rollout_length: int = 500  # T (= reference episode length)
    teacher_mix_initial: float = 1.0  # beta: share of teacher actions executed
    teacher_mix_final: float = 0.0
    teacher_mix_decay_rounds: int = 10
    epochs_per_round: int = 2
    batch_size: int = 64  # sequences per gradient step
    truncated_bptt: int = 0  # 0 = full-sequence BPTT
    learning_rate: float = 1e-3
    # --- DAgger dataset aggregation: re-fit an aggregated dataset each round
    aggregate_capacity: int = 0  # sequences kept (0 = train on the latest round only)
    grad_steps_per_round: int = 0  # minibatch updates per round from the aggregate
    total_grad_steps: int = 0  # > 0 enables warmup-cosine LR over this horizon
    lr_warmup_frac: float = 0.02
    lr_final_scale: float = 0.05  # cosine floor = lr * this
    # --- collect from a random subset of the teachers each round
    teachers_per_round: int = 0  # 0 = use all K teachers every round
    # --- observation standardization, fitted on the round-0 (teacher-driven)
    # data, frozen afterwards, folded into the returned student
    standardize: bool = False
    # --- per-round loss decomposition
    diagnostics: bool = False
    # --- GRU width of the student. 16 is the reference architecture (2,084
    # parameters) and the only width the kernels and checkpoints are built for.
    student_hidden: int = 16
    # --- demonstration injection: collect states whose body-z tilt exceeds
    # this threshold (rad) are labeled by the scripted recovery controller
    # (env.recovery.recovery_action) instead of the teacher. 0 = off. During
    # beta-mixed rounds the label is also the executed action.
    demo_tilt: float = 0.0
    # extends the demo-label criterion to tilt > demo_tilt OR |w| > demo_rate
    demo_rate: float = 0.0
    # the first round(frac * M) envs of every teacher's block execute the
    # scripted demonstrator for the whole collect, in every round
    demo_rollout_frac: float = 0.0
    # per-airframe adaptive demonstrator gain caps (adaptive_gain_caps)
    demo_adaptive: bool = False
    demo_w_cap: float = 10.0
    demo_k_w: float = 30.0
    demo_c_flip: float = 1.0
    demo_c_lag: float = 0.8
    demo_c_bw: float = 1.5
    # --- frames tilted past severe_tilt get weight severe_weight in the BPTT
    # MSE (normalized by total weight). 1.0 = off.
    severe_weight: float = 1.0
    severe_tilt: float = 1.2


class RoundData(NamedTuple):
    """One collected round: [T, K*M, ...] sequences."""

    obs: torch.Tensor  # [T, B, 22] policy observations
    teacher_action: torch.Tensor  # [T, B, 4]
    reset: torch.Tensor  # [T, B] 1.0 where the env auto-reset after this step


def identity_norm(device, obs_dim: int = POLICY_OBS_DIM) -> dict:
    return {"mean": torch.zeros(obs_dim, device=device), "std": torch.ones(obs_dim, device=device)}


def fit_norm(obs: torch.Tensor, std_floor: float = 1e-2) -> dict:
    """Observation normalizer from collected data (obs [..., 22]); the std
    floor keeps near-constant components (a zero previous-action channel at
    episode starts) from exploding the scale."""
    flat = obs.reshape(-1, obs.shape[-1])
    return {
        "mean": flat.mean(0),
        "std": torch.clamp(flat.std(0, correction=0), min=std_floor),
    }


def _norm_obs(obs: torch.Tensor, norm) -> torch.Tensor:
    if norm is None:
        return obs
    return (obs - norm["mean"]) / norm["std"]


def teacher_mix(cfg: DistillConfig, round_idx: int) -> float:
    if cfg.teacher_mix_decay_rounds <= 0:
        return cfg.teacher_mix_final
    frac = min(1.0, round_idx / cfg.teacher_mix_decay_rounds)
    return cfg.teacher_mix_initial + frac * (cfg.teacher_mix_final - cfg.teacher_mix_initial)


def make_demo_fn(cfg: DistillConfig):
    """The scripted demonstrator's action fn (params [N], state [N]) ->
    [N, 4] for this config's gain mode."""

    def demo(params, state):
        return recovery_action(
            params, state, adaptive=cfg.demo_adaptive, w_cap=cfg.demo_w_cap, k_w=cfg.demo_k_w,
            c_flip=cfg.demo_c_flip, c_lag=cfg.demo_c_lag, c_bw=cfg.demo_c_bw,
        )

    return demo


def make_labeler(env: L2F, cfg: DistillConfig):
    """Label function for one collect step: (teacher_actors [K], flat_params
    [K*M], obs_full [K*M, D], state [K*M]) -> labels [K*M, 4].

    Teacher mean actions by default; with cfg.demo_tilt > 0, states tilted
    beyond the threshold (or, with cfg.demo_rate > 0, spinning faster than
    it) take the scripted demonstrator's action. `demo_act` lets make_collect
    reuse one demonstrator evaluation for labels and demo-driven envs."""
    demo_fn = make_demo_fn(cfg)
    obs_dim = env.OBSERVATION_DIM

    def label_fn(teacher_actors, flat_params, obs_full, state, demo_act=None):
        if obs_full.shape[-1] != obs_dim:
            raise ValueError(
                f"labeler expects the privileged obs ({obs_dim}), got {obs_full.shape[-1]}"
            )
        km = obs_full.shape[0]
        k = networks.n_actors(teacher_actors)
        obs_k = obs_full.reshape(k, km // k, -1)
        label = networks.actor_mean(teacher_actors, obs_k).reshape(km, -1)
        if cfg.demo_tilt > 0.0:
            if demo_act is None:
                demo_act = demo_fn(flat_params, state)
            severe = tilt_angle(state.orientation) > cfg.demo_tilt
            if cfg.demo_rate > 0.0:
                severe = severe | (torch.sum(state.angular_velocity**2, -1) > cfg.demo_rate**2)
            label = torch.where(severe[:, None], demo_act, label)
        return label

    return label_fn


def make_collect(env: L2F, cfg: DistillConfig, env_block: Tuple[int, int] = (0, 1)):
    """Round collection: (student_params, teacher_actors [K], env_params
    [K, M], generator, beta, norm=None) -> RoundData. An eager loop of
    cfg.rollout_length env steps; no gradient is recorded.

    `env_block` = (index, count) says that the M envs a teacher has here are
    block `index` of `count` equal blocks of its envs (a process's block,
    `parallel.mesh.distill_block`): the demonstrator-driven envs are then the
    first round(demo_rollout_frac * M * count) of the whole block row, as in
    one process."""
    label_fn = make_labeler(env, cfg)
    use_demo = cfg.demo_tilt > 0.0 or cfg.demo_rollout_frac > 0.0
    demo_fn = make_demo_fn(cfg) if use_demo else None

    @torch.no_grad()
    def collect(student_params, teacher_actors, env_params, generator, beta, norm=None):
        k, m = env_params.mass.shape[:2]
        flat_params = flatten_envs(env_params)
        dev = flat_params.mass.device
        # demonstrator-driven envs: the first d of each teacher's M-block
        # execute the scripted expert for the whole collect
        index, count = env_block
        d_per = int(round(cfg.demo_rollout_frac * m * count))
        demo_driven = ((torch.arange(k * m, device=dev) % m + index * m) < d_per)[:, None]
        es, obs = env.reset(flat_params, generator)
        h0 = student_net.initial_hidden(student_params, k * m)
        h = h0
        obs_seq, label_seq, reset_seq = [], [], []
        for _ in range(cfg.rollout_length):
            h_new, student_action = student_net.apply_step(
                student_params, h, _norm_obs(obs[..., :POLICY_OBS_DIM], norm)
            )
            demo_act = demo_fn(flat_params, es.dynamics) if use_demo else None
            label = label_fn(teacher_actors, flat_params, obs, es.dynamics, demo_act)
            use_teacher = (
                torch.rand((k * m, 1), generator=generator, device=dev) < beta
            ).float()
            action = use_teacher * label + (1.0 - use_teacher) * torch.clamp(
                student_action, -1.0, 1.0
            )
            if d_per > 0:
                action = torch.where(demo_driven, demo_act, action)
            es, next_obs, _, done, _ = env.step(flat_params, es, action, generator)
            # where the env auto-reset, restart the student's hidden state
            h = torch.where(done[:, None], h0, h_new)
            obs_seq.append(obs[..., :POLICY_OBS_DIM])
            label_seq.append(label)
            reset_seq.append(done.float())
            obs = next_obs
        return RoundData(
            obs=torch.stack(obs_seq),
            teacher_action=torch.stack(label_seq),
            reset=torch.stack(reset_seq),
        )

    return collect


def make_relabel(env: L2F):
    """Post-hoc teacher labeling of recorded observation sequences:
    (teacher_actors [K], airframes [K*M], obs [T, K*M, 22]) -> labels
    [T, K*M, 4]. The privileged tail of the observation is a static
    per-airframe function, so the labels of a whole round are one batched MLP
    pass, K x ([T*M, 31] @ [31, 64] ...)."""

    @torch.no_grad()
    def relabel(teacher_actors, airframes, obs):
        t, km = obs.shape[:2]
        k = networks.n_actors(teacher_actors)
        m = km // k
        tail = env.privileged_tail(airframes)  # [K*M, 9]
        full = torch.cat([obs, tail[None].expand(t, km, tail.shape[-1])], -1)
        d = full.shape[-1]
        obs_k = full.reshape(t, k, m, d).permute(1, 0, 2, 3).reshape(k, t * m, d)
        lab = networks.actor_mean(teacher_actors, obs_k)
        return lab.reshape(k, t, m, 4).permute(1, 0, 2, 3).reshape(t, km, 4)

    return relabel


def fused_collect_round(
    student_params, teacher_actors, env_params, generator, env: L2F, cfg: DistillConfig,
    relabel_fn, seed=None,
) -> RoundData:
    """One beta == 0 collect round through the collect kernel and the batched
    relabel pass. Initial states come from the sampler the eager path uses;
    mid-rollout auto-resets use the in-kernel PRNG, seeded from the generator
    (or `seed`). Runs on the device of `env_params` (the kernel on a CUDA
    device, its plain version on the CPU). `distill()` does not call it."""
    from raptor_tpu_torch.ops.collect import make_fused_collect

    flat_params = flatten_envs(env_params)
    dev = flat_params.mass.device
    # the kernel integrates deterministic RK4: the per-step disturbance
    # forces and torques of L2F.dynamics_step are not modelled. Reject
    # airframes that have them rather than collect on other dynamics.
    dist = torch.maximum(
        flat_params.disturbance_force_std.max(), flat_params.disturbance_torque_std.max()
    )
    if float(dist) > 0.0:
        raise ValueError(
            "fused_collect is deterministic-dynamics only: airframes with nonzero "
            "disturbance_{force,torque}_std must use the eager collect (make_collect)"
        )
    state0 = env.sample_state(flat_params, generator)
    if seed is None:
        seed = int(torch.randint(0, 2**31 - 1, (), generator=generator, device=dev))
    run = make_fused_collect(student_params, cfg.rollout_length, env.config, device=dev)
    obs, reset = run(flat_params, state0, seed)
    labels = relabel_fn(teacher_actors, flat_params, obs)
    return RoundData(obs=obs, teacher_action=labels, reset=reset)


def bptt_actions(student_params, obs, reset, norm=None):
    """Student actions [T, B, 4] over a [T, B] batch of sequences with
    reset-masked hidden carry: reset[t] = 1 means the env reset after step t,
    so the hidden state entering step t + 1 is the learned initial state. The
    first row of a collected round always starts fresh. The normalizer
    carries no gradient; the rest is `ops.bptt.bptt` (the BPTT kernels on a
    card, the eager loop on the CPU)."""
    return ops_bptt.bptt(student_params, _norm_obs(obs, norm), reset)


# rotation-matrix R22 channel of the 22-dim policy obs (position 3 dims, then
# row-major R at 3..11): tilt > t  <=>  obs[..., 11] < cos(t)
_R22 = 11


def severe_mask(obs: torch.Tensor, tilt: float) -> torch.Tensor:
    """Boolean [...]: frames whose body-z tilt exceeds `tilt` rad, read from
    the raw (un-normalized) stored policy observation."""
    return obs[..., _R22] < math.cos(tilt)


def bptt_loss(student_params, obs, teacher_action, reset, norm=None,
              severe_weight: float = 1.0, severe_tilt: float = 1.2, group=None):
    """Scalar MSE of bptt_actions against the teacher labels. With
    severe_weight != 1, frames tilted past severe_tilt get that weight in a
    weight-normalized MSE.

    With a process group, `obs` is this process's equal share of the
    minibatch, and the loss is scaled so that its mean over the group is the
    loss of the whole minibatch: the plain MSE is already so, and the
    weighted one is normalized by the group's total weight (an all_reduce of
    a number the parameters do not change) times the group's size."""
    actions = bptt_actions(student_params, obs, reset, norm)
    err2 = (actions - teacher_action) ** 2
    if severe_weight != 1.0:
        w = torch.where(severe_mask(obs, severe_tilt), severe_weight, 1.0)
        total, scale = torch.sum(w), 1.0
        if group is not None:
            dist.all_reduce(total, group=group)
            scale = float(dist.get_world_size(group))
        return scale * torch.sum(err2 * w[..., None]) / (
            torch.clamp(total, min=1.0) * err2.shape[-1]
        )
    return torch.mean(err2)


def make_diagnostics(env: L2F, n_probe_teachers: int = 8, probe_cols: int = 64,
                     severe_tilt: float = 1.2):
    """Per-round loss decomposition. Returns two probes:

    - fresh(student, RoundData, norm) -> {loss_fresh, mse_dim [4],
      severe_frac, severe_frac_probe, loss_severe, loss_hover}: the loss on
      the just-collected on-policy round, its per-action-dim split, the share
      of all collected frames tilted past severe_tilt, and the student's fit
      on that subset against the rest.
    - disagreement(teacher_actors_sub [N], airframes_sub [N], obs [T, C, 22])
      -> scalar: mean variance across N teachers each labeling the same
      policy observations with its own privileged tail, the scale of the
      floor under an MSE conditioned on the 22-dim observation alone.
    """

    @torch.no_grad()
    def fresh(student_params, data: RoundData, norm=None):
        obs = data.obs[:, :probe_cols]
        lab = data.teacher_action[:, :probe_cols]
        rst = data.reset[:, :probe_cols]
        err2 = (bptt_actions(student_params, obs, rst, norm) - lab) ** 2
        sev = severe_mask(obs, severe_tilt).float()  # [T, C]
        per_frame = err2.mean(-1)
        return {
            "loss_fresh": err2.mean(),
            "mse_dim": err2.mean((0, 1)),
            # share over the whole round, not just the probe columns
            "severe_frac": severe_mask(data.obs, severe_tilt).float().mean(),
            "severe_frac_probe": sev.mean(),
            "loss_severe": torch.sum(per_frame * sev) / torch.clamp(sev.sum(), min=1.0),
            "loss_hover": torch.sum(per_frame * (1.0 - sev))
            / torch.clamp(torch.sum(1.0 - sev), min=1.0),
        }

    @torch.no_grad()
    def disagreement(teacher_actors_sub, airframes_sub, obs):
        tails = env.privileged_tail(airframes_sub)  # [N, 9]
        obs_p = obs[:, :probe_cols]
        n, (t, c) = tails.shape[0], obs_p.shape[:2]
        full = torch.cat(
            [obs_p[None].expand(n, t, c, -1), tails[:, None, None].expand(n, t, c, -1)], -1
        )
        labels = networks.actor_mean(teacher_actors_sub, full.reshape(n, t * c, -1))
        return labels.var(0, correction=0).mean()

    return fresh, disagreement


@dataclasses.dataclass
class Aggregate:
    """Device-resident DAgger dataset: a reservoir of [T]-step sequences,
    stored in bfloat16 (observations and labels are O(1); the 0/1 reset mask
    is exact). Columns [0:size) are valid; once full, new rounds overwrite
    uniformly random columns. Updated in place."""

    obs: torch.Tensor  # [T, C, 22] bf16
    teacher_action: torch.Tensor  # [T, C, 4] bf16
    reset: torch.Tensor  # [T, C] bf16 (0/1)
    size: int  # filled columns


def aggregate_init(cfg: DistillConfig, device, obs_dim: int = POLICY_OBS_DIM) -> Aggregate:
    t, c = cfg.rollout_length, cfg.aggregate_capacity
    return Aggregate(
        obs=torch.zeros((t, c, obs_dim), dtype=torch.bfloat16, device=device),
        teacher_action=torch.zeros((t, c, 4), dtype=torch.bfloat16, device=device),
        reset=torch.zeros((t, c), dtype=torch.bfloat16, device=device),
        size=0,
    )


def make_aggregate_add(cfg: DistillConfig):
    """(agg, RoundData, generator) -> agg with the round's B sequences
    appended, or replacing random columns once full. Writes into `agg`."""
    cap = cfg.aggregate_capacity

    @torch.no_grad()
    def add(agg: Aggregate, data: RoundData, generator: torch.Generator) -> Aggregate:
        b = data.obs.shape[1]
        if b > cap:
            raise ValueError(f"round batch {b} exceeds aggregate capacity {cap}")
        dev = agg.obs.device
        seq = agg.size + torch.arange(b, device=dev)
        # replacement columns must be distinct (a duplicate index would drop
        # a new sequence): a permutation prefix, not draws with replacement
        rand = torch.randperm(cap, generator=generator, device=dev)[:b]
        idx = torch.where(seq < cap, seq, rand)
        agg.obs[:, idx] = data.obs.to(torch.bfloat16)
        agg.teacher_action[:, idx] = data.teacher_action.to(torch.bfloat16)
        agg.reset[:, idx] = data.reset.to(torch.bfloat16)
        agg.size = min(agg.size + b, cap)
        return agg

    return add


def lr_schedule(cfg: DistillConfig) -> Callable[[int], float]:
    """Learning rate at optimizer step `count`: constant, or with
    cfg.total_grad_steps > 0 the warmup-cosine schedule of
    `optax.warmup_cosine_decay_schedule` (0.1 lr, linear to lr over the
    warmup, cosine to lr * lr_final_scale at total_grad_steps)."""
    lr = cfg.learning_rate
    if cfg.total_grad_steps <= 0:
        return lambda count: lr
    warmup = max(1, int(cfg.total_grad_steps * cfg.lr_warmup_frac))
    init, alpha = lr * 0.1, cfg.lr_final_scale
    decay_steps = cfg.total_grad_steps - warmup
    if decay_steps <= 0:
        raise ValueError("total_grad_steps must exceed the warmup steps")

    def schedule(count: int) -> float:
        if count < warmup:
            return (init - lr) * (1.0 - count / warmup) + lr
        c = min(count - warmup, decay_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * c / decay_steps))
        return lr * ((1.0 - alpha) * cosine + alpha)

    return schedule


def make_optimizer(cfg: DistillConfig):
    """init(student_params) -> (adam, scheduler): `torch.optim.Adam` (eps 1e-8
    outside the square root, as `optax.adam`) over the student's leaf tensors,
    and the `LambdaLR` that steps its learning rate through `lr_schedule(cfg)`;
    `scheduler.last_epoch` counts the optimizer steps taken."""
    schedule = lr_schedule(cfg)
    base = schedule(0)

    def init(student_params):
        leaves = [t for layer in student_params.values() for t in layer.values()]
        adam = torch.optim.Adam(leaves, lr=base, betas=(0.9, 0.999), eps=1e-8)
        return adam, torch.optim.lr_scheduler.LambdaLR(adam, lambda count: schedule(count) / base)

    return init


def _leaves(student_params) -> List[torch.Tensor]:
    """The student's leaves, in the order its optimizer holds them."""
    return [t for layer in student_params.values() for t in layer.values()]


def _gather(agg: Aggregate, idx: torch.Tensor):
    """The minibatch of columns `idx` of the aggregate, widened to float32."""
    with span("distill.gather"):
        return (agg.obs[:, idx].float(), agg.teacher_action[:, idx].float(),
                agg.reset[:, idx].float())


def _loss_and_grad(student_params, obs, lab, rst, norm, cfg: DistillConfig, group=None):
    """The BPTT loss of one minibatch, detached, and its gradient in each of
    the student's leaves, in the order of `_leaves`."""
    with span("distill.forward"):
        loss = bptt_loss(student_params, obs, lab, rst, norm, cfg.severe_weight,
                         cfg.severe_tilt, group)
    with span("distill.backward"):
        grads = torch.autograd.grad(loss, _leaves(student_params))
    return loss.detach(), list(grads)


def _grad_step(student_params, opt, loss, grads, group=None):
    """One Adam step on a step's loss and its gradients (in the order of
    `_leaves`); leaves the gradients cleared. With a process group, the
    gradients and the loss are averaged over the group, in one all_reduce,
    before the step: the replicated students stay equal bit for bit. Returns
    the loss."""
    adam, scheduler = opt
    if group is not None:
        *grads, loss = average_over(group, [*grads, loss])
    for p, g in zip(_leaves(student_params), grads):
        p.grad = g
    with span("distill.optimizer"):
        adam.step()
        scheduler.step()
        adam.zero_grad(set_to_none=True)
    return loss


def make_train_from_aggregate(cfg: DistillConfig, group=None):
    """Per-round trainer: cfg.grad_steps_per_round minibatch Adam steps, each
    sampling batch_size sequences uniformly from the aggregate's valid prefix
    and running full-sequence BPTT. Returns (train_round, optimizer init);
    train_round(student, opt, agg, generator, norm) -> (student, opt, losses
    [steps]) updates the student in place.

    Without a process group, a step's loss and gradients come from one call
    of a `utils.graphs.Graphed` kept in the closure: the draw of the
    minibatch's columns, then `_gather` and `_loss_and_grad` as its body. Its
    key is the config and, by identity, the student's leaves, the aggregate's
    tensors and the normalizer's; on a card the second step with a key
    captures and later steps replay. `distill()` reuses one student and one
    in-place aggregate, so it captures once. Every step goes through
    `_grad_step`, whose Adam step is the same on every path.

    With a process group the step is eager, and `cfg` is this process's share
    (`parallel.mesh.shard_distill_config`): each process draws its
    batch_size columns from its own block of the aggregate with its own
    generator, and the replicated student steps on the gradient averaged
    over the group (`_grad_step`). The learning-rate schedule steps alike on
    every process, and the losses are the group's."""
    step = graphs.Graphed("distill.step")

    def train_round(student_params, opt, agg: Aggregate, generator, norm=None):
        normed = () if norm is None else (norm["mean"], norm["std"])
        key = (cfg, graphs.Identity(*_leaves(student_params), agg.obs, agg.teacher_action,
                                    agg.reset, *normed))
        specs = (("randint", (cfg.batch_size,), max(agg.size, 1)),)

        def body(draws, _):
            loss, grads = _loss_and_grad(student_params, *_gather(agg, draws[0]), norm, cfg,
                                         group)
            return [loss, *grads]

        losses = []
        for _ in range(cfg.grad_steps_per_round):
            with span("distill.step"):
                if group is None:
                    loss, *grads = step(key, generator, specs, body)
                else:
                    loss, *grads = body(graphs.draw(generator, specs), ())
                losses.append(_grad_step(student_params, opt, loss, grads, group))
        return student_params, opt, torch.stack(losses)

    return train_round, make_optimizer(cfg)


def make_train_epoch(cfg: DistillConfig):
    """One-epoch trainer over the latest round: shuffles the sequences and
    runs minibatch Adam steps with full-sequence BPTT at a constant learning
    rate. Returns (train_epoch, optimizer init)."""

    def train_epoch(student_params, opt, data: RoundData, generator, norm=None):
        b = data.obs.shape[1]
        bs = min(cfg.batch_size, b)
        n_batches = b // bs
        perm = torch.randperm(b, generator=generator, device=data.obs.device)[: n_batches * bs]
        losses = [
            _grad_step(student_params, opt, *_loss_and_grad(
                student_params, data.obs[:, idx], data.teacher_action[:, idx],
                data.reset[:, idx], norm, cfg))
            for idx in perm.reshape(n_batches, bs)
        ]
        return student_params, opt, torch.stack(losses)

    constant = dataclasses.replace(cfg, total_grad_steps=0)
    return train_epoch, make_optimizer(constant)


def draw_round_teachers(generator: torch.Generator, k_total: int, k_sub: int) -> torch.Tensor:
    """The K_sub teachers of one round, a random subset of the K_total:
    the first K_sub of a permutation drawn from `generator`. Over several
    processes every process draws the same subset from a generator seeded
    alike everywhere and takes its block (`parallel.mesh.round_teacher_block`)."""
    return torch.randperm(k_total, generator=generator, device=generator.device)[:k_sub]


def _detached(student_params):
    return {
        layer: {k: v.detach().clone() for k, v in tensors.items()}
        for layer, tensors in student_params.items()
    }


def distill(
    generator: torch.Generator,
    env: L2F,
    teacher_actors,  # stacked [K] actor params (privileged obs)
    airframes: DynamicsParams,  # [K]
    cfg: DistillConfig = DistillConfig(),
    n_rounds: int = 10,
    log_fn=None,
    round_hook=None,
) -> Tuple[dict, List[float]]:
    """Run the full distillation on the device of `airframes` (the generator
    must live there too). Returns (student_params, loss_history).

    With cfg.standardize the returned parameters, and everything handed to
    round_hook, have the fitted normalizer folded into dense_0
    (policy.network.fold_norm, exact), so exports and evaluations see a plain
    reference-schema policy. log_fn(tag, value, step) also receives the
    seconds each round spent in collect, aggregate add and training
    (`seconds/*`, after a device synchronize)."""
    dev = airframes.mass.device
    if dev.type == "cuda":
        ops_bptt.require_built(cfg.student_hidden)
    student = student_net.init_params(generator, hidden_dim=cfg.student_hidden)
    for layer in student.values():
        for t in layer.values():
            t.requires_grad_(True)
    collect = make_collect(env, cfg)
    aggregated = cfg.aggregate_capacity > 0 and cfg.grad_steps_per_round > 0
    if aggregated:
        agg = aggregate_init(cfg, dev)
        agg_add = make_aggregate_add(cfg)
        train_round, optim_init = make_train_from_aggregate(cfg)
    else:
        train_epoch, optim_init = make_train_epoch(cfg)
    opt = optim_init(student)
    env_params = broadcast_airframe_to_envs(airframes, cfg.envs_per_teacher)

    # per-round teacher subsampling: collect from a random K_sub-subset each
    # round, so the env-step budget per round stays fixed without shrinking
    # the population the aggregate ultimately covers
    k_total = airframes.mass.shape[0]
    k_sub = cfg.teachers_per_round
    subsample = bool(k_sub) and k_sub < k_total

    def take(idx):
        return networks.take_actors(teacher_actors, idx), tree_map(lambda x: x[idx], env_params)

    if cfg.diagnostics:
        diag_fresh, diag_disagree = make_diagnostics(
            env, severe_tilt=(cfg.demo_tilt if cfg.demo_tilt > 0.0 else cfg.severe_tilt)
        )
        n_probe = min(8, k_total)

    norm: Optional[dict] = None

    def folded(p):
        p = _detached(p)
        return p if norm is None else student_net.fold_norm(p, norm["mean"], norm["std"])

    def log(tag, value, step):
        if log_fn is not None:
            log_fn(tag, value, step)

    def log_seconds(tag, t0, step):
        """Host seconds since t0, after the device has finished its queue;
        neither synchronized nor read without a log_fn."""
        if log_fn is not None:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            log_fn(tag, time.perf_counter() - t0, step)

    loss_history: List[float] = []
    grad_step = 0
    env_steps = 0
    for r in range(n_rounds):
        beta = teacher_mix(cfg, r)
        if subsample:
            actors_r, params_r = take(draw_round_teachers(generator, k_total, k_sub))
        else:
            actors_r, params_r = teacher_actors, env_params
        t0 = time.perf_counter()
        data = collect(student, actors_r, params_r, generator, beta, norm)
        if cfg.standardize and norm is None:
            # fitted once on the round-0 (teacher-driven, beta = 1)
            # distribution and frozen: a standardize layer fitted before
            # training, not a running statistic
            norm = fit_norm(data.obs)
        env_steps += cfg.rollout_length * data.obs.shape[1]
        log_seconds("seconds/collect", t0, env_steps)
        if aggregated:
            t0 = time.perf_counter()
            agg = agg_add(agg, data, generator)
            log_seconds("seconds/aggregate_add", t0, env_steps)
            t0 = time.perf_counter()
            student, opt, losses = train_round(student, opt, agg, generator, norm)
            losses = losses.tolist()
            log_seconds("seconds/train", t0, env_steps)
            # a decimated loss series (the full one is a point per gradient step)
            stride = max(1, len(losses) // 64)
            for j in range(0, len(losses), stride):
                log("loss", losses[j], grad_step + j)
            grad_step += len(losses)
            # the true optimizer-step counter (the loss series is decimated)
            log("gradient_steps", float(grad_step), env_steps)
            loss_history.append(losses[-1])
        else:
            t0 = time.perf_counter()
            for _ in range(cfg.epochs_per_round):
                student, opt, losses = train_epoch(student, opt, data, generator, norm)
                losses = losses.tolist()
                for loss in losses:
                    log("loss", loss, grad_step)
                    grad_step += 1
                loss_history.append(losses[-1])
            log_seconds("seconds/train", t0, env_steps)
        if cfg.diagnostics and log_fn is not None:
            fresh = diag_fresh(student, data, norm)
            pidx = torch.randperm(k_total, generator=generator, device=dev)[:n_probe]
            spread = diag_disagree(
                networks.take_actors(teacher_actors, pidx),
                tree_map(lambda x: x[pidx], airframes), data.obs,
            )
            log("diagnostics/loss_fresh", float(fresh["loss_fresh"]), grad_step)
            for d in range(4):
                log(f"diagnostics/mse_dim{d}", float(fresh["mse_dim"][d]), grad_step)
            log("diagnostics/teacher_disagreement", float(spread), grad_step)
            for tag in ("severe_frac", "severe_frac_probe", "loss_severe", "loss_hover"):
                log(f"diagnostics/{tag}", float(fresh[tag]), grad_step)
        if round_hook is not None:
            round_hook(r, folded(student), env_steps)
    return folded(student), loss_history
