"""CLI: recurrent (GRU) SAC with domain randomization.

Counterpart of `raptor_tpu/apps/train_gru_sac.py`, with every flag of it plus
`--device` (default `cuda`; it raises where there is no card). N
domain-randomized airframes, the GRU actor (foundation-policy backbone) and
recurrent twin critics, sequence replay with reset-masked BPTT:

    python -m raptor_tpu_torch.apps.train_gru_sac --n-envs 256 --super-steps 2000
    python -m raptor_tpu_torch.apps.train_gru_sac \\
        --init-actor raptor_tpu_torch/data/student_rateFlagCurPure.npz   # fine-tune a student
    python -m raptor_tpu_torch.apps.train_gru_sac --n-envs 8 --super-steps 2 \\
        --rollout-length 8 --seq-len 8 --burn-in 2 --device cpu        # a tiny run on the CPU

Metrics go to the run's tfevents log every 10 super-steps under the JAX
package's tags; each evaluation logs the five statistics of
`rl.evaluation.EvalStats` (`evaluation/episode_length/std` besides the JAX
CLI's four). At the end the actor's mu head is written in the reference
schema: `.h5` where h5py is installed, else the `.npz` form of it
(`checkpoint/h5.py`).
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util

import torch

from raptor_tpu_torch.checkpoint import from_numpy
from raptor_tpu_torch.checkpoint import h5 as ckpt_h5
from raptor_tpu_torch.device import resolve_device
from raptor_tpu_torch.env import EnvConfig, L2F, eval_parity_init, sample_population
from raptor_tpu_torch.policy import network as gru_net
from raptor_tpu_torch.rl import evaluation, runner_gru, sac_gru
from raptor_tpu_torch.rl.runner import ACTION_DIM
from raptor_tpu_torch.utils.extrack import Run

EVAL_TAGS = {
    "return_mean": "evaluation/return/mean",
    "return_std": "evaluation/return/std",
    "episode_length_mean": "evaluation/episode_length/mean",
    "episode_length_std": "evaluation/episode_length/std",
    "share_terminated": "evaluation/share_terminated",
}


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--n-envs", type=int, default=256)
    p.add_argument("--super-steps", type=int, default=1000)
    p.add_argument("--rollout-length", type=int, default=64)
    p.add_argument("--gradient-steps", type=int, default=8)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--seq-len", type=int, default=64)
    p.add_argument("--burn-in", type=int, default=8,
                   help="window steps that only warm up hidden states (no loss)")
    p.add_argument("--warmup-super-steps", type=int, default=8)
    p.add_argument("--steps-per-call", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--eval-every", type=int, default=100)
    p.add_argument("--eval-max-angle", type=float, default=0.0,
                   help="eval-parity InitConfig.max_angle for the evaluation/* tags "
                        "(0 = training init); 1.0 gives numbers comparable with the "
                        "reference log (apps/eval_parity.py protocol)")
    p.add_argument("--privileged-critics", action=argparse.BooleanOptionalAction, default=True,
                   help="critics consume the full privileged obs while the actor sees the "
                        "22-dim policy slice; --no-privileged-critics trains everything on "
                        "the policy slice")
    p.add_argument("--critic-hidden", type=int, default=0,
                   help="critic GRU width (0 = same as actor hidden_dim)")
    p.add_argument("--init-actor", default=None,
                   help="RL fine-tuning: initialise the actor backbone from a distilled "
                        "student (.h5 or .npz); dense_0/gru_1 copy exactly, the student's "
                        "head becomes the mu half of the squashed-Gaussian head (log-std "
                        "half at --init-log-std); tanh(mu) mildly compresses the student's "
                        "clip(identity) actions")
    p.add_argument("--init-log-std", type=float, default=-2.0)
    p.add_argument("--actor-lr", type=float, default=3e-4)
    p.add_argument("--critic-lr", type=float, default=3e-4)
    p.add_argument("--init-angle-power", type=float, default=1.0,
                   help="training-init severity exponent (InitConfig.angle_power); >1 "
                        "oversamples severe starts for recovery fine-tuning")
    p.add_argument("--experiments-dir", default="experiments")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain PyTorch path)")
    return p.parse_args(argv)


def configs(args):
    """(training env, evaluation env, GRURunnerConfig, SACGRUConfig) of the
    flags."""
    env = L2F(EnvConfig(init=dataclasses.replace(
        EnvConfig().init, angle_power=args.init_angle_power)))
    eval_env = env if args.eval_max_angle <= 0 else L2F(EnvConfig(init=dataclasses.replace(
        eval_parity_init(), max_angle=args.eval_max_angle)))
    run_cfg = runner_gru.GRURunnerConfig(
        n_envs=args.n_envs, rollout_length=args.rollout_length,
        gradient_steps=args.gradient_steps, batch_size=args.batch_size,
        sample_seq_len=args.seq_len, replay_capacity=4096,
    )
    cfg = sac_gru.SACGRUConfig(
        burn_in=args.burn_in,
        actor_obs_dim=run_cfg.actor_obs_dim if args.privileged_critics else None,
        critic_hidden_dim=args.critic_hidden or None,
        actor_lr=args.actor_lr, critic_lr=args.critic_lr,
    )
    return env, eval_env, run_cfg, cfg


def evaluate_actor(learner, eval_env, run_cfg, cfg, n_envs: int, seed: int, device):
    """The deterministic actor tanh(mu) on min(n_envs, 64) airframes for one
    episode cap. A generator made anew from `seed` each call gives every
    evaluation the same airframes and initial states."""
    m = min(n_envs, 64)
    gen = torch.Generator(device).manual_seed(seed)
    with torch.no_grad():
        p_eval = sample_population(gen, m)
        sf = sac_gru.recurrent_actor_step(learner.actor, cfg)
        return evaluation.evaluate(
            eval_env, p_eval, lambda h, o: sf(h, o[..., : run_cfg.actor_obs_dim]),
            gru_net.initial_hidden(learner.actor, m), gen, m, eval_env.EPISODE_LENGTH)


def mu_actor(actor) -> dict:
    """The actor's GRU backbone and the mu rows of its head, as numpy: the
    reference schema's policy."""
    a = {layer: {k: v.detach().cpu().numpy() for k, v in t.items()} for layer, t in actor.items()}
    return {
        "dense_0": a["dense_0"],
        "gru_1": a["gru_1"],
        "dense_2": {"weights": a["dense_2"]["weights"][:ACTION_DIM],
                    "biases": a["dense_2"]["biases"][:ACTION_DIM]},
    }


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    env, eval_env, run_cfg, cfg = configs(args)
    gen = torch.Generator(device).manual_seed(args.seed)
    params = sample_population(gen, args.n_envs)
    state = runner_gru.gru_trainer_init(gen, env, params, run_cfg, cfg)
    if args.init_actor:
        # fine-tune a distilled student; the actor's Adam starts afresh
        student = from_numpy(ckpt_h5.load_actor(args.init_actor), device)
        sac_gru.set_actor(state.learner, sac_gru.graft_actor_from_student(
            state.learner.actor, student, ACTION_DIM, args.init_log_std), cfg)
    if args.steps_per_call > 1:
        super_step = runner_gru.make_gru_multi_step(env, run_cfg, cfg, args.steps_per_call)
    else:
        super_step = runner_gru.make_gru_super_step(env, run_cfg, cfg)

    run = Run(base_dir=args.experiments_dir, name="gru_sac")
    run.snapshot_config({"run_cfg": run_cfg, "cfg": cfg, "seed": args.seed})
    for _ in range(args.warmup_super_steps):
        runner_gru.collect_sequences(state, env, params, run_cfg, cfg, random_actions=True)
    steps_per = run_cfg.rollout_length * run_cfg.n_envs * args.steps_per_call
    for i in range(args.super_steps):
        state, metrics = super_step(state, params)
        step = (i + 1) * steps_per
        if (i + 1) % 10 == 0:
            run.log({name: float(getattr(metrics, name)) for name in metrics._fields}, step)
        if args.eval_every and (i + 1) % args.eval_every == 0:
            stats = evaluate_actor(state.learner, eval_env, run_cfg, cfg, args.n_envs,
                                   args.seed + 1, device)
            run.log({tag: float(getattr(stats, name)) for name, tag in EVAL_TAGS.items()}, step)

    suffix = ".h5" if importlib.util.find_spec("h5py") else ".npz"
    path = run.checkpoint_path(args.super_steps * steps_per, suffix)
    ckpt_h5.save_actor(path, mu_actor(state.learner.actor), checkpoint_name=run.name)
    run.close()
    print(f"gru-sac actor: {path}")
    return path


if __name__ == "__main__":
    main()
