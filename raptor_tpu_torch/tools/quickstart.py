"""Quickstart tour of the port, the five steps of `examples/quickstart.py`:

    python -m raptor_tpu_torch.tools.quickstart                       # the card, shipped checkpoint
    python -m raptor_tpu_torch.tools.quickstart --device cpu \\
        --checkpoint raptor_tpu_torch/data/student_rateFlagCurPure.npz

1. `Raptor` inference on 2 zero observations;
2. 256 random airframes, 10 eager env steps under a zero action;
3. the same dynamics as one launch of rollout kernel B1
   (`ops.rollout.fused_rollout`, 20 steps; its plain version on the CPU);
4. one SAC super-step on the population;
5. the policy exported as a standalone C++ header.

`--checkpoint` defaults to the shipped checkpoint, as JAX's `Raptor()` does
(it needs $RAPTOR_REFERENCE_DIR). Prints the five lines and returns their
numbers, with step 3's tensors under "rollout_io" (its inputs and outputs,
for holding B1 against its plain version); writes the numbers as JSON only
where `--out` names a file.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
from typing import Optional

import numpy as np
import torch

from raptor_tpu_torch.device import resolve_device


def run(checkpoint: Optional[str] = None, device="cuda", n: int = 256, airframes=None,
        state=None, seed: int = 0, verbose: bool = True) -> dict:
    """The five steps on `device`. `airframes` [n] and `state` [n] (a
    `State`) replace the sampled airframes and initial states where given."""
    from raptor_tpu_torch.checkpoint import code_export
    from raptor_tpu_torch.env import EnvConfig, EnvState, L2F, sample_population
    from raptor_tpu_torch.env.types import tree_map
    from raptor_tpu_torch.ops.rollout import fused_rollout
    from raptor_tpu_torch.policy import Raptor
    from raptor_tpu_torch.rl import runner, sac

    dev = resolve_device(device)
    say = print if verbose else (lambda *a: None)
    out = {}

    # 1. inference with the foundation policy
    policy = Raptor(checkpoint, batch_size=2, device=dev)
    policy.reset()
    action = policy.evaluate_step(np.zeros((2, 22), np.float32))
    say("1. Raptor action:", action.shape, action[0])
    out["raptor_action"] = action.tolist()

    # 2. vectorized domain-randomized environments
    env = L2F(EnvConfig())
    gen = torch.Generator(device=dev).manual_seed(seed)
    to_dev = lambda tree: tree_map(lambda x: x.to(dev), tree)  # noqa: E731
    params = to_dev(airframes) if airframes is not None else sample_population(gen, n)
    if state is None:
        es, obs = env.reset(params, gen)
    else:
        state = to_dev(state)
        es = EnvState(dynamics=state, action_history=state.position.new_zeros((n, 1, 4)),
                      angvel_history=state.angular_velocity[:, None].clone(),
                      t=torch.zeros(n, dtype=torch.int32, device=dev))
    zero = torch.zeros((n, 4), device=dev)
    for _ in range(10):
        es, obs, reward, done, _ = env.step(params, es, zero, gen)
    say("2. vector env:", tuple(obs.shape), "reward mean", float(reward.mean()))
    out.update(env_obs_shape=list(obs.shape), env_reward_mean=float(reward.mean()),
               env_done=int(done.sum()))

    # 3. the same dynamics through rollout kernel B1
    final, alive, length = fused_rollout(params, es.dynamics, zero, 20, device=dev)
    say("3. fused rollout: mean survived steps", float(length.mean()))
    out["rollout_mean_length"] = float(length.mean())
    out["rollout_alive"] = float(alive.mean())
    out["rollout_io"] = {"params": params, "state": es.dynamics, "action": zero, "steps": 20,
                         "state_out": final, "alive": alive, "length": length}

    # 4. a SAC super-step on the population
    run_cfg = runner.RunnerConfig(n_envs=n, rollout_length=4, gradient_steps=4, batch_size=128,
                                  replay_capacity=256)
    trainer = runner.trainer_init(torch.Generator(device=dev).manual_seed(seed + 2), env, params,
                                  run_cfg, sac.SACConfig())
    trainer, metrics = runner.make_super_step(env, run_cfg, sac.SACConfig())(trainer, params)
    say("4. SAC super-step: critic loss", float(metrics.critic_loss))
    out["sac_critic_loss"] = float(metrics.critic_loss)

    # 5. the policy as a standalone C++ header (deployment path)
    params_np = {layer: {k: v.cpu().numpy() for k, v in tensors.items()}
                 for layer, tensors in policy.params.items()}
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "policy.h")
        code_export.export_header_file(path, params_np)
        with open(path) as f:
            out["header"] = f.read()
    out["header_lines"] = len(out["header"].splitlines(keepends=True))
    say("5. exported C++ header:", out["header_lines"], "lines")
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--checkpoint", default=None,
                   help="student checkpoint (.h5 or .npz); default: the shipped checkpoint")
    p.add_argument("--device", default="cuda")
    p.add_argument("--n", type=int, default=256, help="airframes of steps 2-4")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None, help="JSON report path")
    args = p.parse_args(argv)
    out = run(args.checkpoint, args.device, args.n, seed=args.seed)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({k: v for k, v in out.items() if k not in ("header", "rollout_io")}, f,
                      indent=2)
    return out


if __name__ == "__main__":
    main()
