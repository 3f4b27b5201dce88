"""The port's live visualisation path on the CPU: `env.ui.UIClient`,
`apps.ui_server.UIServer` and `apps.visualize`.

- a `UIClient` through the port's `UIServer`: handshake, relay to an early
  viewer, late-join replay of the scene, the HTTP viewer page, the
  namespace closing; a requested namespace and a malformed frame;
- the frames the client sends equal the JAX builders' JSON on the same
  airframes and states;
- `visualize --record` through a live server and offline (no server, or no
  `websockets`), and a failure of the rollout itself is raised, not taken
  for offline mode.

The patterns are `tests/test_ui_server.py` and `tests/test_ui_protocol.py`.
"""

import asyncio
import json
import os
import sys
import urllib.request

import jax
import numpy as np
import pytest
import torch

from raptor_tpu.env import sample_population as jsample
from raptor_tpu.env import ui as jui
from raptor_tpu.env.types import State as JState
from raptor_tpu_torch.apps import visualize
from raptor_tpu_torch.apps.ui_server import UIServer
from raptor_tpu_torch.checkpoint import dynamics_params_from_numpy
from raptor_tpu_torch.env import EnvConfig, L2F, sample_population, ui
from raptor_tpu_torch.env.types import State

NPZ = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "raptor_tpu_torch",
                   "data", "student_rateFlagCurPure.npz")
SETUP = ["ui_message", "parameters_message"]


def _states(n=2):
    return State(position=torch.zeros(n, 3), orientation=torch.tensor([[1.0, 0, 0, 0]] * n),
                 linear_velocity=torch.zeros(n, 3), angular_velocity=torch.zeros(n, 3),
                 rpm=torch.full((n, 4), 0.5))


async def _recv(ws, count):
    return [json.loads(await asyncio.wait_for(ws.recv(), 5)) for _ in range(count)]


def test_ui_client_through_the_port_server_end_to_end():
    websockets = pytest.importorskip("websockets")

    async def drive():
        srv = await UIServer().start("127.0.0.1", 0)
        port = srv.port
        gen = torch.Generator().manual_seed(0)
        params = sample_population(gen, 2)
        es, _ = L2F(EnvConfig()).reset(params, gen)
        early = await websockets.connect(f"ws://127.0.0.1:{port}/ui")
        async with ui.UIClient(f"ws://127.0.0.1:{port}/backend") as client:
            assert client.namespace == "0"  # server-assigned
            await client.set_ui()
            await client.set_parameters(params, n_envs=2)
            await client.render(es.dynamics, torch.zeros(2, 4))
            got = await _recv(early, 3)
            assert [m["channel"] for m in got] == SETUP + ["state_action_message"]
            assert all(m["data"]["namespace"] == "0" for m in got)
            assert len(got[2]["data"]["states"]) == 2
            assert len(got[2]["data"]["states"][0]["position"]) == 3
            # a late viewer gets the scene replayed, not the transient frame
            late = await websockets.connect(f"ws://127.0.0.1:{port}/ui")
            replay = await _recv(late, 2)
            assert [m["channel"] for m in replay] == SETUP
            rot = replay[1]["data"]["parameters"][0]["dynamics"]["rotor_positions"]
            assert len(rot) == 4 and len(rot[0]) == 3
            html = await asyncio.to_thread(lambda: urllib.request.urlopen(
                f"http://127.0.0.1:{port}/", timeout=5).read().decode())
            assert "raptor-tpu ui-server" in html and "/ui" in html
        closed = json.loads(await asyncio.wait_for(early.recv(), 5))
        assert closed == {"channel": "namespace_closed", "data": {"namespace": "0"}}
        await early.close()
        await late.close()
        await srv.stop()

    asyncio.run(drive())


def test_requested_namespace_and_malformed_frame():
    websockets = pytest.importorskip("websockets")

    async def drive():
        srv = await UIServer().start("127.0.0.1", 0)
        ws = await websockets.connect(f"ws://127.0.0.1:{srv.port}/backend/swarm1")
        hs = json.loads(await asyncio.wait_for(ws.recv(), 5))
        assert hs["data"]["namespace"] == "swarm1"
        viewer = await websockets.connect(f"ws://127.0.0.1:{srv.port}/ui")
        await ws.send("{not json")  # must not end the stream
        await ws.send(json.dumps({"channel": "ui_message", "data": {}}))
        m = json.loads(await asyncio.wait_for(viewer.recv(), 5))
        assert m == {"channel": "ui_message", "data": {"namespace": "swarm1"}}
        await ws.close()
        await viewer.close()
        await srv.stop()

    asyncio.run(drive())


def test_client_frames_equal_the_jax_client_frames():
    """The port's client and the JAX client, each through the port's server,
    on the same airframes and states: the relayed frames are equal."""
    websockets = pytest.importorskip("websockets")
    jparams = jsample(jax.random.key(0), 2)
    params = dynamics_params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    states, actions = _states(2), np.full((2, 4), 0.25, np.float32)

    async def frames(client_cls, p, s, a):
        srv = await UIServer().start("127.0.0.1", 0)
        viewer = await websockets.connect(f"ws://127.0.0.1:{srv.port}/ui")
        async with client_cls(f"ws://127.0.0.1:{srv.port}/backend") as client:
            await client.set_ui(model_url="https://example/x500.glb")
            await client.set_parameters(p, 2)
            await client.render(s, a)
            got = await _recv(viewer, 3)
        await viewer.close()
        await srv.stop()
        return got

    jstates = JState(**{k: getattr(states, k).numpy() for k in (
        "position", "orientation", "linear_velocity", "angular_velocity", "rpm")})
    want = asyncio.run(frames(jui.UIClient, jparams, jstates, actions))
    got = asyncio.run(frames(ui.UIClient, params, states, torch.as_tensor(actions)))
    assert got == want


def _visualize_args(tmp_path, url, extra=()):
    return [NPZ, "--n-envs", "2", "--steps", "5", "--dt", "0", "--airframe", "crazyflie",
            "--device", "cpu", "--url", url, "--record", str(tmp_path / "session.jsonl"),
            *extra]


def _recorded(tmp_path):
    return [json.loads(line) for line in (tmp_path / "session.jsonl").read_text().splitlines()]


def test_visualize_records_a_session_through_a_live_server(tmp_path, capsys):
    websockets = pytest.importorskip("websockets")

    async def scenario():
        srv = await UIServer().start("127.0.0.1", 0)
        viewer = await websockets.connect(f"ws://127.0.0.1:{srv.port}/ui")
        await asyncio.to_thread(visualize.main, _visualize_args(
            tmp_path, f"ws://127.0.0.1:{srv.port}/backend"))
        got = await _recv(viewer, 2 + 5 + 1)
        await viewer.close()
        await srv.stop()
        return got

    relayed = asyncio.run(scenario())
    assert [m["channel"] for m in relayed] == (
        SETUP + ["state_action_message"] * 5 + ["namespace_closed"])
    lines = _recorded(tmp_path)
    assert [m["channel"] for m in lines] == SETUP + ["state_action_message"] * 5
    assert [m["data"]["states"] for m in lines[2:]] == [m["data"]["states"] for m in relayed[2:7]]
    st = lines[2]["data"]["states"][0]
    assert set(st) == {"position", "orientation", "linear_velocity", "angular_velocity", "rpm"}
    assert np.all(np.isfinite(st["position"]))
    assert "connected to" in capsys.readouterr().out


@pytest.mark.parametrize("why", ["no_server", "no_websockets"])
def test_visualize_offline(tmp_path, capsys, monkeypatch, why):
    if why == "no_websockets":
        monkeypatch.setitem(sys.modules, "websockets", None)  # import raises ImportError
    visualize.main(_visualize_args(tmp_path, "ws://127.0.0.1:1/none", ["--print-every", "2"]))
    out = capsys.readouterr().out
    assert "offline" in out
    assert len([line for line in out.splitlines() if line.startswith('{"position"')]) == 3
    lines = _recorded(tmp_path)
    assert [m["channel"] for m in lines] == SETUP + ["state_action_message"] * 5
    assert all(m["data"]["namespace"] == "offline" for m in lines)


def test_visualize_raises_a_rollout_failure(tmp_path, capsys, monkeypatch):
    """Offline mode is about the connection: a failing rollout is raised."""
    def broken(*a, **k):
        raise FloatingPointError("the rollout failed")

    monkeypatch.setattr(visualize.policy_net, "apply_step", broken)
    with pytest.raises(FloatingPointError):
        visualize.main(_visualize_args(tmp_path, "ws://127.0.0.1:1/none"))
