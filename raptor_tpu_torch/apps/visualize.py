"""CLI: 3D visualization demo: rolls out a policy on the device and streams
its frames to a running ui-server.

Counterpart of `raptor_tpu/apps/visualize.py`, with the same flags plus
`--device`:

    python -m raptor_tpu_torch.apps.ui_server &          # or the reference's ui-server
    python -m raptor_tpu_torch.apps.visualize raptor_tpu_torch/data/student_rateFlagCurPure.npz --n-envs 8

Where no ui-server answers (or `websockets` is not installed) it runs
offline and prints frames as JSON lines, so the rollout and the protocol can
be checked without a network; `--record` writes every message that was, or
would have been, sent. Offline mode covers the connection only: a failure of
the rollout itself is raised.
"""

from __future__ import annotations

import argparse
import asyncio
import json

import torch

from raptor_tpu_torch.checkpoint import from_numpy, h5
from raptor_tpu_torch.device import resolve_device
from raptor_tpu_torch.env import EnvConfig, InitConfig, L2F, presets, sample_population, ui
from raptor_tpu_torch.env.types import tree_map
from raptor_tpu_torch.policy import network as policy_net


async def connect(url: str):
    """A connected `ui.UIClient`, or None (printed) where no server can be
    reached."""
    try:
        import websockets
    except ImportError as e:
        print(f"ui-server unreachable ({type(e).__name__}: no websockets); offline, "
              "printing frames")
        return None
    client = ui.UIClient(url)
    try:
        await client.__aenter__()
    except (OSError, asyncio.TimeoutError, websockets.exceptions.WebSocketException) as e:
        print(f"ui-server unreachable ({type(e).__name__}); offline, printing frames")
        return None
    return client


async def run(args):
    device = resolve_device(args.device)
    if args.shipped or not args.checkpoint:
        from raptor_tpu_torch.policy.raptor import shipped_checkpoint_path

        args.checkpoint = shipped_checkpoint_path()
    policy = from_numpy(h5.load_actor(args.checkpoint), device)

    env = L2F(EnvConfig(init=InitConfig(max_angle=0.8, position_range=0.25)))
    n = args.n_envs
    if args.airframe == "random":
        params = sample_population(torch.Generator(device).manual_seed(args.seed), n)
    else:
        one = getattr(presets, args.airframe)(device)
        params = tree_map(lambda x: x.expand(n, *x.shape[1:]).contiguous(), one)

    es, _ = env.reset(params, torch.Generator(device).manual_seed(args.seed + 1))
    state = es.dynamics
    h = policy_net.initial_hidden(policy, n)
    prev = torch.zeros((n, 4), device=device)

    client = await connect(args.url)
    if client is not None:
        await client.set_ui()
        await client.set_parameters(params, n)
        print(f"connected to {args.url}, namespace={client.namespace}")

    # --record: the protocol session (every message that was, or would have
    # been, sent) as JSON lines, a replayable ui-server session
    rec = open(args.record, "w") if args.record else None
    ns = client.namespace if client is not None else "offline"
    try:
        if rec is not None:
            rec.write(json.dumps(ui.ui_message(ns)) + "\n")
            rec.write(json.dumps(ui.parameters_message(ns, params, n)) + "\n")
        for t in range(args.steps):
            obs = env.observe(params, state, prev)
            h, action = policy_net.apply_step(policy, h, obs[:, :22])
            action = torch.clamp(action, -1.0, 1.0)
            state, _ = env.dynamics_step(params, state, action, None)
            prev = action
            will_print = client is None and t % args.print_every == 0
            msg = None
            if rec is not None or will_print:  # device -> host copy only when used
                msg = ui.state_action_message(ns, state, action)
            if rec is not None:
                rec.write(json.dumps(msg) + "\n")
            if client is not None:
                await client.render(state, action)
                await asyncio.sleep(args.dt)
            elif will_print:
                print(json.dumps(msg["data"]["states"][0]))
    finally:
        if rec is not None:
            rec.close()
        if client is not None:
            await client.__aexit__()
    if rec is not None:
        print(f"recorded session -> {args.record}")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("checkpoint", nargs="?", help="policy checkpoint, .h5 or .npz")
    p.add_argument("--shipped", action="store_true")
    p.add_argument("--airframe", choices=["random", "crazyflie", "x500"], default="x500")
    p.add_argument("--n-envs", type=int, default=8)
    p.add_argument("--steps", type=int, default=500)
    p.add_argument("--dt", type=float, default=0.01)
    p.add_argument("--url", default=ui.DEFAULT_URL)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--print-every", type=int, default=100)
    p.add_argument("--record", help="write the protocol session as JSON lines")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    asyncio.run(run(args))


if __name__ == "__main__":
    main()
