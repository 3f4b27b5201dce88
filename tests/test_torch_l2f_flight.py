"""The port's l2f shim, ui messages, flight logs and flight evaluation on the
CPU, against the JAX package:

- the reference README's `vector8` loop with the port's `Raptor`;
- both shims stepped 20 times under the same actions from states handed
  across, to 1e-5, with the default and a history observation;
- the ActionHistory(h) / AngularVelocityDelayed(d) rings (after
  tests/test_l2f_compat.py);
- the ui messages equal the JAX package's JSON;
- flight-log CSVs written by either package read in the other;
- `flight_eval` analyze and replay equal the JAX package's on the same log,
  a hover-start record equals the JAX record, and a record -> analyze ->
  replay round trip.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from raptor_tpu.apps import flight_eval as j_flight_eval
from raptor_tpu.env import l2f_compat as jl2f
from raptor_tpu.env import ui as jui
from raptor_tpu.env.types import EnvConfig as JEnvConfig
from raptor_tpu.env.types import ObservationConfig as JObservationConfig
from raptor_tpu.utils import flightlog as jflightlog
from raptor_tpu_torch.apps import flight_eval
from raptor_tpu_torch.checkpoint import dynamics_params_from_numpy, state_from_numpy
from raptor_tpu_torch.env import EnvConfig, ObservationConfig
from raptor_tpu_torch.env import l2f_compat as l2f
from raptor_tpu_torch.env import ui
from raptor_tpu_torch.utils import flightlog

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PURE_NPZ = os.path.join(ROOT, "raptor_tpu_torch", "data", "student_rateFlagCurPure.npz")
PURE_H5 = os.path.join(ROOT, "artifacts", "student_rateFlagCurPure.h5")
HISTORY = dict(action_history_length=3, angular_velocity_delay=2)


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def test_vector8_readme_loop_on_the_cpu():
    """chip_smoke.py's phase-17 loop (finite observations and positions, every
    dt 0.01 s; it raises otherwise), here 100 steps on the CPU."""
    env, state = chip_smoke.readme_loop(torch.device("cpu"), 100)
    assert env.N_ENVIRONMENTS == 8 and env.OBSERVATION_DIM > 22
    assert np.all(np.isfinite(state.dynamics.position.numpy()))
    s0 = state.states[0]
    assert s0.orientation.shape == (4,) and s0.rpm.shape == (4,)
    assert state.dynamics.position.device.type == "cpu"


def _hand_across(jvec, vec, device, seed):
    """JAX-sampled parameters and states, and the same in the port's shim."""
    jdev = jl2f.Device()
    jrng, jenv = jvec.VectorRng(), jvec.VectorEnvironment()
    jparams, jstate = jvec.VectorParameters(), jvec.VectorState()
    jl2f.initialize_rng(jdev, jrng, seed)
    jl2f.sample_initial_parameters(jdev, jenv, jparams, jrng)
    jl2f.sample_initial_state(jdev, jenv, jparams, jstate, jrng)
    params, state = vec.VectorParameters(), vec.VectorState()
    params.stacked = dynamics_params_from_numpy(to_np(jparams.stacked), "cpu")
    state.dynamics = state_from_numpy(to_np(jstate.dynamics), "cpu")
    state.action_history = torch.from_numpy(np.array(jstate.action_history))
    state.angvel_history = torch.from_numpy(np.array(jstate.angvel_history))
    return (jdev, jrng, jenv, jparams, jstate), (params, state)


@pytest.mark.parametrize("obs_cfg", [{}, HISTORY], ids=["default", "history"])
def test_shim_matches_the_jax_shim_from_handed_states(obs_cfg):
    n = 6
    jvec = jl2f.vector(n, JEnvConfig(observation=JObservationConfig(**obs_cfg)))
    vec = l2f.vector(n, EnvConfig(observation=ObservationConfig(**obs_cfg)))
    device, rng, env = l2f.Device("cpu"), vec.VectorRng(), vec.VectorEnvironment()
    (jdev, jrng, jenv, jparams, jstate), (params, state) = _hand_across(jvec, vec, device, 5)
    jnext, nxt = jvec.VectorState(), vec.VectorState()
    assert env.OBSERVATION_DIM == jenv.OBSERVATION_DIM
    obs = np.zeros((n, env.OBSERVATION_DIM), np.float32)
    jobs = np.zeros_like(obs)
    actions = np.random.default_rng(0).uniform(-1.3, 1.3, (20, n, 4)).astype(np.float32)
    for a in actions:
        l2f.observe(device, env, params, state, obs, rng)
        jl2f.observe(jdev, jenv, jparams, jstate, jobs, jrng)
        np.testing.assert_allclose(obs, jobs, atol=1e-5, rtol=0)
        dts = l2f.step(device, env, params, state, a, nxt, rng)
        np.testing.assert_array_equal(dts, jl2f.step(jdev, jenv, jparams, jstate, a, jnext, jrng))
        state.assign(nxt)
        jstate.assign(jnext)
    for k in ("position", "orientation", "linear_velocity", "angular_velocity", "rpm"):
        np.testing.assert_allclose(getattr(state.dynamics, k).numpy(),
                                   np.asarray(getattr(jstate.dynamics, k)), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(state.action_history.numpy(), np.asarray(jstate.action_history))
    np.testing.assert_allclose(state.angvel_history.numpy(), np.asarray(jstate.angvel_history),
                               atol=1e-5, rtol=0)
    assert float(state.action_history.abs().max()) == 1.0  # the rings hold clipped actions


def test_history_observation_config():
    """h = 3, d = 2: oldest-first action ring and the delayed angular velocity
    (after tests/test_l2f_compat.py)."""
    device = l2f.Device("cpu")
    vec = l2f.vector(4, EnvConfig(observation=ObservationConfig(**HISTORY)))
    rng, env = vec.VectorRng(), vec.VectorEnvironment()
    params, state, next_state = vec.VectorParameters(), vec.VectorState(), vec.VectorState()
    assert env.OBSERVATION_DIM == 18 + 4 * 3 + 9
    obs = np.zeros((4, env.OBSERVATION_DIM), np.float32)
    l2f.initialize_rng(device, rng, 7)
    l2f.sample_initial_parameters(device, env, params, rng)
    l2f.sample_initial_state(device, env, params, state, rng)
    l2f.observe(device, env, params, state, obs, rng)
    np.testing.assert_allclose(obs[:, 18:30], 0.0)
    np.testing.assert_allclose(obs[:, 15:18], state.dynamics.angular_velocity.numpy(), atol=1e-6)
    for v in (0.1, 0.2, 0.3):
        l2f.step(device, env, params, state, np.full((4, 4), v, np.float32), next_state, rng)
        state.assign(next_state)
    l2f.observe(device, env, params, state, obs, rng)
    for i, v in enumerate((0.1, 0.2, 0.3)):
        np.testing.assert_allclose(obs[:, 18 + 4 * i:22 + 4 * i], v, atol=1e-6)
    np.testing.assert_allclose(obs[:, 15:18], state.angvel_history[:, 0].numpy(), atol=1e-6)
    assert state.prev_action.shape == (4, 4)
    np.testing.assert_allclose(state.prev_action.numpy(), 0.3, atol=1e-6)


def test_ui_messages_equal_jax_json():
    vec, jvec = l2f.vector8, jl2f.vector8
    device = l2f.Device("cpu")
    (jdev, _, jenv, jparams, jstate), (params, state) = _hand_across(jvec, vec, device, 3)
    env = vec.VectorEnvironment()
    actions = np.random.default_rng(1).uniform(-1, 1, (8, 4))
    assert json.dumps(ui.ui_message("ns", "https://example/x500.glb")) == json.dumps(
        jui.ui_message("ns", "https://example/x500.glb"))
    assert json.dumps(ui.parameters_message("ns", params.stacked, 8)) == json.dumps(
        jui.parameters_message("ns", jparams.stacked, 8))
    assert json.dumps(ui.state_action_message("ns", state.dynamics, actions)) == json.dumps(
        jui.state_action_message("ns", jstate.dynamics, actions))
    handle, jhandle = l2f.UI("ns-42"), jl2f.UI("ns-42")
    assert l2f.set_ui_message(device, env, handle) == jl2f.set_ui_message(jdev, jenv, jhandle)
    assert l2f.set_parameters_message(device, env, params, handle) == \
        jl2f.set_parameters_message(jdev, jenv, jparams, jhandle)
    assert l2f.set_state_action_message(device, env, params, handle, state, actions) == \
        jl2f.set_state_action_message(jdev, jenv, jparams, jhandle, jstate, actions)


def _random_log(t, with_action, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(t, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return dict(t_us=np.arange(t, dtype=np.int64) * 10_000,
                position=rng.normal(size=(t, 3)).astype(np.float32), orientation=q,
                linear_velocity=rng.normal(size=(t, 3)).astype(np.float32),
                angular_velocity=rng.normal(size=(t, 3)).astype(np.float32),
                action=rng.uniform(-1, 1, (t, 4)).astype(np.float32) if with_action else None)


@pytest.mark.parametrize("with_action", [True, False], ids=["flight", "mocap"])
def test_flight_logs_cross_read(tmp_path, with_action):
    fields = _random_log(30, with_action)
    flightlog.write_csv(str(tmp_path / "port.csv"), flightlog.FlightLog(**fields))
    jflightlog.write_csv(str(tmp_path / "jax.csv"), jflightlog.FlightLog(**fields))
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()
    for got in (flightlog.read_csv(str(tmp_path / "jax.csv")),
                jflightlog.read_csv(str(tmp_path / "port.csv"))):
        want = jflightlog.read_csv(str(tmp_path / "jax.csv"))
        for name, v in want._asdict().items():
            if v is None:
                assert getattr(got, name) is None
            else:
                np.testing.assert_array_equal(getattr(got, name), v)
        assert got.duration_s == want.duration_s and got.dt_s == want.dt_s


@pytest.fixture(scope="module")
def recorded(tmp_path_factory):
    """A 50-step hover-start flight of the committed student, recorded by the
    port on the CPU."""
    path = str(tmp_path_factory.mktemp("flight") / "flight.csv")
    flight_eval.main(["record", path, "--checkpoint", PURE_NPZ, "--hover-start", "--steps", "50",
                      "--device", "cpu"])
    return path


def _report(cli, argv, path):
    cli.main([*argv, "--out", path])
    with open(path) as f:
        return json.load(f)


def test_hover_start_record_equals_the_jax_record(recorded, tmp_path):
    """From rest nothing is random: both packages record the same flight."""
    jpath = str(tmp_path / "jax.csv")
    j_flight_eval.main(["record", jpath, "--checkpoint", PURE_H5, "--hover-start", "--steps", "50"])
    got, want = flightlog.read_csv(recorded), flightlog.read_csv(jpath)
    np.testing.assert_array_equal(got.t_us, want.t_us)
    for name in ("position", "orientation", "linear_velocity", "angular_velocity", "action"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name), atol=1e-5, rtol=0)


def test_analyze_equals_jax_analyze(recorded, tmp_path):
    crash = tmp_path / "crash.csv"
    fields = _random_log(50, False)
    fields["position"][:] = 0.0
    fields["position"][40:, 2] = -2.0  # falls out of the arena (bound 0.6 m)
    flightlog.write_csv(str(crash), flightlog.FlightLog(**fields))
    for log, crashed in ((recorded, False), (str(crash), True)):
        got = _report(flight_eval, ["analyze", log, "--device", "cpu"], str(tmp_path / "p.json"))
        want = _report(j_flight_eval, ["analyze", log], str(tmp_path / "j.json"))
        assert list(got) == list(want) and got["crashed"] == want["crashed"] == crashed
        for key, value in want.items():
            np.testing.assert_allclose(got[key], value, atol=1e-6, rtol=0, err_msg=key)


def test_replay_equals_jax_replay(recorded, tmp_path):
    got = _report(flight_eval, ["replay", recorded, "--device", "cpu"], str(tmp_path / "p.json"))
    want = _report(j_flight_eval, ["replay", recorded], str(tmp_path / "j.json"))
    assert list(got) == list(want) and got["n_steps"] == want["n_steps"] == 50
    for key, value in want.items():
        np.testing.assert_allclose(got[key], value, atol=1e-5, rtol=0, err_msg=key)


def test_record_analyze_replay_round_trip(tmp_path):
    log_path = str(tmp_path / "flight.csv")
    flight_eval.main(["record", log_path, "--checkpoint", PURE_NPZ, "--hover-start",
                      "--steps", "120", "--seed", "1", "--device", "cpu"])
    log = flightlog.read_csv(log_path)
    assert len(log.t_us) == 121 and log.action.shape == (121, 4)
    np.testing.assert_allclose(np.linalg.norm(log.orientation, axis=1), 1.0, atol=1e-4)
    report = _report(flight_eval, ["analyze", log_path, "--device", "cpu"],
                     str(tmp_path / "analysis.json"))
    assert not report["crashed"] and report["position_rmse_m"] < 0.6
    assert abs(report["rate_hz"] - 100.0) < 1.0 and report["n_samples"] == 121
    replay = _report(flight_eval, ["replay", log_path, "--device", "cpu"],
                     str(tmp_path / "replay.json"))
    assert replay["divergence_final_m"] < 1e-2, replay
    with pytest.raises(SystemExit, match="action columns"):
        mocap = str(tmp_path / "mocap.csv")
        flightlog.write_csv(mocap, flightlog.FlightLog(**_random_log(5, False)))
        flight_eval.main(["replay", mocap, "--device", "cpu"])


def test_recorded_crash_is_detected(tmp_path):
    """A flight that terminates mid-record keeps its out-of-bounds terminal
    state in the log, so analyze reports the crash."""
    from raptor_tpu_torch.checkpoint import h5
    from raptor_tpu_torch.policy import network

    bad = str(tmp_path / "untrained.npz")
    h5.save_actor(bad, network.init_params(torch.Generator().manual_seed(7)))
    log_path = str(tmp_path / "crash_flight.csv")
    flight_eval.main(["record", log_path, "--checkpoint", bad, "--steps", "400", "--seed", "2",
                      "--device", "cpu"])
    assert len(flightlog.read_csv(log_path).t_us) < 401  # an untrained policy cannot fly 4 s
    assert _report(flight_eval, ["analyze", log_path, "--device", "cpu"],
                   str(tmp_path / "crash.json"))["crashed"]
