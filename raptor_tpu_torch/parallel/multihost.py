"""Multi-process runs: one process a device under `torch.distributed`.

Counterpart of `raptor_tpu/parallel/multihost.py`. JAX runs one SPMD program
over a mesh that spans processes; PyTorch has no such program, so the port
runs one process a device (NCCL between cards, gloo between CPU processes),
each holding its block of the env or population axis and a replicated
learner (`parallel/mesh.py`).

Per-process random streams: `host_generator` folds the process index into a
seed, so processes draw independent streams while process 0 draws the
stream a single process draws.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from raptor_tpu_torch.device import resolve_device

# what torchrun (and any env:// launch) sets in every process
_CLUSTER_ENV_VARS = ("MASTER_ADDR", "WORLD_SIZE", "RANK")
_GOLDEN = 0x9E3779B97F4A7C15  # 2^64 / golden ratio: spreads the folded seeds


def _cluster_env_present() -> bool:
    return all(os.environ.get(v) for v in _CLUSTER_ENV_VARS)


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device="cuda",
) -> None:
    """Join the process group: NCCL for `device` cuda, gloo for cpu.

    `coordinator_address` ("host:port" or "tcp://host:port") with
    `num_processes` and `process_id` names the group explicitly; without it
    the group is read from the environment (`env://`: MASTER_ADDR,
    MASTER_PORT, WORLD_SIZE, RANK, as torchrun sets them). A no-op where the
    group already exists, or where there is no coordinator and no cluster
    variables (a single process). Any other failure is raised, so a
    multi-process launch never falls back to one process."""
    if dist.is_initialized():
        return
    backend = "nccl" if resolve_device(device).type == "cuda" else "gloo"
    if coordinator_address is not None:
        url = coordinator_address if "://" in coordinator_address else (
            f"tcp://{coordinator_address}")
        if num_processes is None or process_id is None:
            raise ValueError("an explicit coordinator needs num_processes and process_id")
        dist.init_process_group(backend, init_method=url, world_size=num_processes,
                                rank=process_id)
    elif _cluster_env_present():
        dist.init_process_group(backend, init_method="env://")


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def host_generator(seed: int, process_index: Optional[int] = None,
                   device="cpu") -> torch.Generator:
    """A generator whose stream is this process's own: the index folded into
    the seed. Process 0 draws the stream of `manual_seed(seed)`."""
    if process_index is None:
        process_index = dist.get_rank() if dist.is_initialized() else 0
    return torch.Generator(device=device).manual_seed((seed + process_index * _GOLDEN) % 2**64)


def global_env_count(n_envs_per_host: int) -> int:
    return n_envs_per_host * process_count()


def make_global_array(local: torch.Tensor, axis: int = 0, group=None) -> torch.Tensor:
    """The global tensor from every process's block along `axis`, in rank
    order, on every process (all_gather_into_tensor). The port has no
    sharded array type: the result is a plain tensor holding all blocks."""
    world = dist.get_world_size(group) if dist.is_initialized() else 1
    if world == 1:
        return local.clone()
    moved = local.movedim(axis, 0).contiguous()
    out = moved.new_empty((world * moved.shape[0], *moved.shape[1:]))
    dist.all_gather_into_tensor(out, moved, group=group)
    return out.movedim(0, axis)


def free_port() -> int:
    """A TCP port on localhost that is free now (for a process group's
    coordinator)."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_processes(n: int, module: str, argv: Sequence[str], timeout: float,
                  cwd: Optional[str] = None) -> List[str]:
    """Run `python -m module *argv --worker n --port P --rank r` for r = 0 ..
    n - 1 at once, P a free port for their process group, and return their
    standard outputs in rank order. Raises RuntimeError where one process
    fails or the time runs out; no process outlives the call."""
    port = free_port()
    base = [sys.executable, "-m", module, *argv, "--worker", str(n), "--port", str(port)]
    procs = [subprocess.Popen(base + ["--rank", str(r)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, cwd=cwd) for r in range(n)]
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=timeout))
    except subprocess.TimeoutExpired:
        raise RuntimeError("timeout") from None
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    bad = [(proc.returncode, err) for proc, (_, err) in zip(procs, outs) if proc.returncode]
    if bad:
        raise RuntimeError(f"rc {bad[0][0]}: {bad[0][1].strip()[-500:]}")
    return [out for out, _ in outs]


def scaling_report(steps_per_s_1: float, steps_per_s_n: float, n: int) -> dict:
    """Scaling efficiency: the rate at n devices over n times the rate at 1."""
    eff = steps_per_s_n / (steps_per_s_1 * n) if steps_per_s_1 > 0 else 0.0
    return {
        "devices": n,
        "steps_per_s": steps_per_s_n,
        "scaling_efficiency": eff,
    }
