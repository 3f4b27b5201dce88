"""Break collect kernel B3's first-steps error against the eager closed loop
down by observation channel (counterpart of
`experiments/probe_collect_parity.py`):

    python -m raptor_tpu_torch.tools.probe_collect_parity            # the card
    python -m raptor_tpu_torch.tools.probe_collect_parity --device cpu

1,024 random airframes from gentle starts (max angle 0.2, velocity stds
0.02) inside wide bounds (position 50 m, angular rate 1000 rad/s), a student
of random weights from a seed, 4 steps: B3 (`ops.collect.make_fused_collect`,
seed 3; its plain version on the CPU) against the eager loop of
`policy.network.apply_step` and `L2F.step` from the same states. The error
of each row t is reported per channel group, under the JAX probe's keys:

  ch 0-2   position          ch 12-14 linear velocity
  ch 3-11  rotation matrix   ch 15-17 angular velocity
  ch 18-21 previous action (the student's GRU step)

The JAX probe also reports `xla_default_vs_highest_precision` (its XLA
reference at the TPU's default bf16 matmul precision against the highest);
the port's matmuls are full f32 throughout, so it has no such column.
Prints the report; writes it only where `--out` names a file.
"""

from __future__ import annotations

import argparse
import json

import torch

from raptor_tpu_torch.device import resolve_device

KERNEL_SEED = 3  # the in-kernel reset PRNG's seed (no reset happens in these steps)
GROUPS = {
    "position(0-2)": slice(0, 3),
    "rotmat(3-11)": slice(3, 12),
    "linvel(12-14)": slice(12, 15),
    "angvel(15-17)": slice(15, 18),
    "prev_action(18-21)": slice(18, 22),
}


def probe_config():
    from raptor_tpu_torch.env import EnvConfig, InitConfig, TerminationConfig

    return EnvConfig(
        init=InitConfig(max_angle=0.2, linear_velocity_std=0.02, angular_velocity_std=0.02),
        termination=TerminationConfig(position_bound=50.0, angular_velocity_bound=1000.0))


@torch.no_grad()
def collect_and_reference(student, params, state, n_steps: int, config, device):
    """(B3's obs [T, N, 22], its reset mask [T, N], the eager loop's obs
    [T, N, 22]) from the same airframes and initial states."""
    from raptor_tpu_torch.env import EnvState, L2F
    from raptor_tpu_torch.env.types import tree_map
    from raptor_tpu_torch.ops.collect import make_fused_collect
    from raptor_tpu_torch.policy import network

    dev = resolve_device(device)
    params, state = (tree_map(lambda x: x.to(dev), t) for t in (params, state))
    student = {layer: {k: v.to(dev) for k, v in t.items()} for layer, t in student.items()}
    obs_f, reset_f = make_fused_collect(student, n_steps, config, device=dev)(params, state,
                                                                             KERNEL_SEED)

    env = L2F(config)
    n = state.position.shape[0]
    es = EnvState(dynamics=state, action_history=state.position.new_zeros((n, 1, 4)),
                  angvel_history=state.angular_velocity[:, None].clone(),
                  t=torch.zeros(n, dtype=torch.int32, device=dev))
    obs = env.observe(params, state, es.action_history, es.angvel_history)
    h = network.initial_hidden(student, n)
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for _ in range(n_steps):
        h, a = network.apply_step(student, h, obs[..., :22])
        rows.append(obs[..., :22])
        es, obs, _, _, _ = env.step(params, es, torch.clamp(a, -1.0, 1.0), gen)
    return obs_f, reset_f, torch.stack(rows)


def report(obs_f, reset_f, obs_x, backend: str) -> dict:
    """The JAX probe's report: per row t the largest |error| of each channel
    group and over all channels, and the resets the kernel drew."""
    out = {"backend": backend, "steps": {}}
    for t in range(obs_f.shape[0]):
        err = (obs_f[t] - obs_x[t]).abs()
        row = {k: float(err[:, sl].max()) for k, sl in GROUPS.items()}
        row["max"] = float(err.max())
        out["steps"][f"t{t}"] = row
    out["resets_first_steps"] = float(reset_f.sum())
    return out


def run(device="cuda", n: int = 1024, n_steps: int = 4) -> dict:
    from raptor_tpu_torch.env import L2F, sample_population
    from raptor_tpu_torch.policy import network

    dev = resolve_device(device)
    config = probe_config()
    student = network.init_params(torch.Generator(device=dev).manual_seed(7))
    params = sample_population(torch.Generator(device=dev).manual_seed(5), n)
    state = L2F(config).sample_state(params, torch.Generator(device=dev).manual_seed(9))
    return report(*collect_and_reference(student, params, state, n_steps, config, dev), dev.type)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    p.add_argument("--n", type=int, default=1024, help="envs")
    p.add_argument("--steps", type=int, default=4)
    p.add_argument("--out", default=None, help="JSON report path")
    args = p.parse_args(argv)
    out = run(args.device, args.n, args.steps)
    print(json.dumps(out, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=2)
    return out


if __name__ == "__main__":
    main()
