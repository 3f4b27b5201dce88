"""CLI: weak-scaling benchmark of the population super-step over devices.

Counterpart of `raptor_tpu/apps/bench_scaling.py`. It measures WEAK scaling
of the teacher-farm super-step at N = 1, 2, 4, 8 devices: each device trains
a fixed block of `--teachers-per-device` teachers (the population split on
the 'pop' axis, `parallel/mesh.py`), so ideal throughput grows linearly and
efficiency = rate_N / (N rate_1) (`parallel.multihost.scaling_report`).

Where JAX shards one program over a mesh, the port runs one process a
device: for each N the CLI starts N processes joined by `torch.distributed`
(NCCL on the first N cards with `--platform cuda`, gloo between CPU
processes with `--platform cpu`). The time of a super-step is the marginal
time between two iteration counts, each bracketed by a synchronize and a
barrier, of the slowest process. The teachers of a block need no
collective except for the metrics.

    python -m raptor_tpu_torch.apps.bench_scaling --platform cpu --devices 1,2 --out s.json
    python -m raptor_tpu_torch.apps.bench_scaling            # the cards: 1, 2, 4, 8 up to those present

CPU rows validate the process group, the layout and the harness, not the
scaling of cards; rows with more processes than cores are marked
`oversubscribed`. A device count above the cards present is an error. Each
row carries the kernel launches of its processes (`launches`, summed over
the ranks): the super-step runs as eager PyTorch and launches none.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from raptor_tpu_torch.apps.roofline import card_name_and_power_limit
from raptor_tpu_torch.parallel.multihost import run_processes, scaling_report

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
FLAGS = ("teachers_per_device", "envs_per_teacher", "rollout_length", "gradient_steps",
         "batch_size", "replay_capacity", "iters_lo", "iters_hi")


def _worker(n_devices: int, rank: int, port: int, args) -> dict:
    """This process's part of the N-process measurement; every process
    returns the same row (the slowest process's time)."""
    import torch.distributed as dist

    from raptor_tpu_torch.distill import population
    from raptor_tpu_torch.env import EnvConfig, L2F
    from raptor_tpu_torch.parallel import make_mesh, shard_env_pytree
    from raptor_tpu_torch.parallel.multihost import host_generator, initialize_distributed
    from raptor_tpu_torch.rl import sac
    from raptor_tpu_torch.utils.profiling import launches

    if args.platform == "cuda":
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
        # one process a device: the host's cores split between the processes
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n_devices))
    initialize_distributed(f"localhost:{port}", n_devices, rank, device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dist.barrier()

    env = L2F(EnvConfig())
    k = args.teachers_per_device * n_devices  # weak scaling
    pop_cfg = population.PopulationConfig(
        n_teachers=args.teachers_per_device,
        envs_per_teacher=args.envs_per_teacher,
        rollout_length=args.rollout_length,
        gradient_steps=args.gradient_steps,
        batch_size=args.batch_size,
        replay_capacity=args.replay_capacity,
        warmup_super_steps=1,
    )
    sac_cfg = sac.SACConfig(actor_hidden=(64, 64), critic_hidden=(64, 64))
    mesh = make_mesh(n_devices, ("pop",))
    airframes = shard_env_pytree(
        population.sample_teacher_airframes(torch.Generator(device).manual_seed(0), k),
        mesh, mesh_dim="pop")
    states, env_params, run_cfg = population.population_init(
        host_generator(1, device=device), env, airframes, pop_cfg, sac_cfg)
    warmup = population.make_population_warmup(env, run_cfg)
    super_step = population.make_population_super_step(env, run_cfg, sac_cfg)
    states = warmup(states, env_params)

    def step_and_metric():
        nonlocal states
        states, metrics = super_step(states, env_params)
        # the population's one collective: its mean critic loss
        loss = metrics.critic_loss.sum()
        dist.all_reduce(loss)
        return float(loss) / k

    step_and_metric()  # warm-up
    sync()

    def timed(iters):
        t0 = time.perf_counter()
        for _ in range(iters):
            loss = step_and_metric()
        sync()
        return time.perf_counter() - t0, loss

    lo, hi = args.iters_lo, args.iters_hi
    (t_lo, _), (t_hi, loss) = timed(lo), timed(hi)
    slowest = torch.tensor([(t_hi - t_lo) / (hi - lo)], dtype=torch.float64, device=device)
    dist.all_reduce(slowest, op=dist.ReduceOp.MAX)
    per_call = float(slowest)
    # every launch of this process, counted from its start
    summed = torch.tensor(list(launches.values()), device=device)
    dist.all_reduce(summed)
    env_steps_per_call = k * args.envs_per_teacher * args.rollout_length
    row = {
        "devices": n_devices,
        "teachers": k,
        "platform": device.type,
        "card": card_name_and_power_limit() if device.type == "cuda" else None,
        "processes": dist.get_world_size(),
        "backend": dist.get_backend(),
        "env_steps_per_call": env_steps_per_call,
        "seconds_per_super_step": per_call,
        "env_steps_per_s": env_steps_per_call / max(per_call, 1e-9),
        "critic_loss": loss,
        "launches": dict(zip(launches, summed.tolist())),
        # processes on one host share its cores: past the core count they
        # time-share them, and weak scaling must flatten there
        "host_cpu_count": os.cpu_count(),
        "oversubscribed": device.type == "cpu" and n_devices > (os.cpu_count() or 1),
    }
    dist.destroy_process_group()
    return row


def _run_processes(n: int, args) -> dict:
    """Run the n processes of one device count; rank 0's row, or an error
    row."""
    argv = ["--platform", args.platform]
    for flag in FLAGS:
        argv += ["--" + flag.replace("_", "-"), str(getattr(args, flag))]
    try:
        outs = run_processes(n, "raptor_tpu_torch.apps.bench_scaling", argv, args.timeout, ROOT)
    except RuntimeError as e:
        return {"devices": n, "error": str(e)}
    return json.loads(outs[0].strip().splitlines()[-1])


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--devices", default=None,
                   help="comma-separated device counts (default 1,2,4,8; on cuda those up "
                        "to the cards present)")
    p.add_argument("--platform", default="cuda", choices=["cpu", "cuda"],
                   help="cuda = one process on each of the first N cards; cpu = gloo "
                        "processes on the host (plumbing validation)")
    p.add_argument("--teachers-per-device", type=int, default=8)
    p.add_argument("--envs-per-teacher", type=int, default=8)
    p.add_argument("--rollout-length", type=int, default=8)
    p.add_argument("--gradient-steps", type=int, default=4)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--replay-capacity", type=int, default=256)
    p.add_argument("--iters-lo", type=int, default=4)
    p.add_argument("--iters-hi", type=int, default=16)
    p.add_argument("--timeout", type=int, default=900,
                   help="per-device-count timeout of the processes (s)")
    p.add_argument("--out", default=None, help="JSON report path")
    p.add_argument("--worker", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    args = p.parse_args(argv)

    if args.worker:
        row = _worker(args.worker, args.rank, args.port, args)
        if args.rank == 0:
            print(json.dumps(row))
        return None

    cards = torch.cuda.device_count() if args.platform == "cuda" else None
    if args.devices is None:
        counts = [n for n in (1, 2, 4, 8) if cards is None or n <= max(cards, 1)]
    else:
        counts = [int(x) for x in args.devices.split(",")]
    if cards is not None and max(counts) > cards:
        raise ValueError(f"--devices {','.join(map(str, counts))}: this host has {cards} "
                         "CUDA device(s)")
    rows = [_run_processes(n, args) for n in counts]

    ok = [r for r in rows if "env_steps_per_s" in r]
    base = next((r for r in ok if r["devices"] == 1), None)
    reports = [
        scaling_report(base["env_steps_per_s"], r["env_steps_per_s"], r["devices"])
        for r in ok
        if base is not None
    ]
    out = {
        "workload": "population pre-training super-step (weak scaling, "
                    f"{args.teachers_per_device} teachers/device)",
        "platform": args.platform,
        "processes_per_device": 1,
        "host_cpu_count": os.cpu_count(),
        "cuda_devices": cards,
        "note": (
            "CPU processes joined by gloo: validates the process group, the population "
            "layout, the collectives and the measurement harness, NOT the scaling of "
            "cards; no efficiency at N > 1 is claimed for a card from these rows. Rows "
            "with oversubscribed=true have more processes than cores: they time-share "
            "cores, so weak scaling flattens or regresses there by construction, and "
            "they are excluded from scaling_valid."
            if args.platform == "cpu"
            else f"one process a card, NCCL; this host has {cards} card(s), so rows exist "
                 "only up to that count"
        ),
        "rows": rows,
        "scaling": reports,
        "scaling_valid": [
            r for r, row in zip(reports, ok)
            if base is not None and not row.get("oversubscribed")
        ],
    }
    print(json.dumps(out, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=2)
    if len(ok) < len(rows):
        sys.exit(1)
    return out


if __name__ == "__main__":
    main()
