"""The port's environment (`raptor_tpu_torch.env`) held to the JAX package.

Inputs are drawn with numpy or by the JAX samplers and handed to both
packages; the port runs on the CPU. Tolerances: float32 ops in another order
agree to ~1e-6 relative, so dynamics use atol 1e-5 (the JAX package's own
golden-trajectory bound); observe, reward and terminated are elementwise in
the same order and must agree exactly (the privileged tail, which takes logs
and a norm, to 1e-6).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raptor_tpu.env import dynamics as jdyn
from raptor_tpu.env import maths as jmaths
from raptor_tpu.env import presets as jpresets
from raptor_tpu.env import randomization as jrand
from raptor_tpu.env import types as jtypes
from raptor_tpu.env.quad import L2F as JL2F
from raptor_tpu_torch.checkpoint import dynamics_params_from_numpy, state_from_numpy
from raptor_tpu_torch.env import dynamics as tdyn
from raptor_tpu_torch.env import maths as tmaths
from raptor_tpu_torch.env import presets as tpresets
from raptor_tpu_torch.env import randomization as trand
from raptor_tpu_torch.env import types as ttypes
from raptor_tpu_torch.env.quad import EnvState, L2F as TL2F

STATE_FIELDS = ["position", "orientation", "linear_velocity", "angular_velocity", "rpm"]


def t(x) -> torch.Tensor:
    return torch.as_tensor(np.array(x, np.float32))


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def assert_state_close(got: ttypes.State, want, atol=1e-5, rtol=0.0):
    for f in STATE_FIELDS:
        np.testing.assert_allclose(
            getattr(got, f).numpy(), np.asarray(getattr(want, f)), atol=atol, rtol=rtol,
            err_msg=f,
        )


@pytest.fixture(scope="module")
def batch():
    """64 JAX-sampled airframes and initial states, and their port copies."""
    n = 64
    jparams = jrand.sample_population(jax.random.key(0), n)
    jenv = JL2F(jtypes.EnvConfig())
    es, _ = jax.vmap(jenv.reset)(jax.random.split(jax.random.key(1), n), jparams)
    tparams = dynamics_params_from_numpy(to_np(jparams), "cpu")
    tstate = state_from_numpy(to_np(es.dynamics), "cpu")
    return jparams, es, tparams, tstate, n


CONFIGS = ["RewardConfig", "TerminationConfig", "InitConfig", "ObservationConfig", "EnvConfig"]


@pytest.mark.parametrize("name", CONFIGS + ["RandomizationConfig"])
def test_config_defaults_match_jax(name):
    jmod, tmod = (jrand, trand) if name == "RandomizationConfig" else (jtypes, ttypes)
    jc, tc = getattr(jmod, name)(), getattr(tmod, name)()
    assert [f.name for f in dataclasses.fields(jc)] == [f.name for f in dataclasses.fields(tc)]
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)


def test_eval_parity_init_and_observation_dims():
    assert dataclasses.asdict(jtypes.eval_parity_init()) == dataclasses.asdict(
        ttypes.eval_parity_init()
    )
    assert (ttypes.POLICY_OBS_DIM, ttypes.PRIVILEGED_TAIL_DIM) == (
        jtypes.POLICY_OBS_DIM, jtypes.PRIVILEGED_TAIL_DIM)
    for h in (1, 2):
        for priv in (True, False):
            oc = dict(action_history_length=h, privileged=priv)
            assert ttypes.observation_dim(
                ttypes.EnvConfig(observation=ttypes.ObservationConfig(**oc))
            ) == jtypes.observation_dim(
                jtypes.EnvConfig(observation=jtypes.ObservationConfig(**oc))
            )


def test_maths_match_jax():
    rng = np.random.default_rng(0)
    q = rng.normal(size=(32, 4)).astype(np.float32)
    qu = q / np.linalg.norm(q, axis=-1, keepdims=True)
    v = rng.normal(size=(32, 3)).astype(np.float32)
    b = rng.normal(size=(32, 4)).astype(np.float32)
    angle = rng.uniform(-3, 3, size=32).astype(np.float32)
    cases = [
        (tmaths.quat_to_rotm(t(qu)), jax.vmap(jmaths.quat_to_rotm)(qu)),
        (tmaths.quat_mul(t(q), t(b)), jax.vmap(jmaths.quat_mul)(q, b)),
        (tmaths.quat_derivative(t(qu), t(v)), jax.vmap(jmaths.quat_derivative)(qu, v)),
        (tmaths.quat_normalize(t(q)), jax.vmap(jmaths.quat_normalize)(q)),
        (tmaths.quat_rotate(t(qu), t(v)), jax.vmap(jmaths.quat_rotate)(qu, v)),
        (tmaths.quat_from_axis_angle(t(v), t(angle)),
         jax.vmap(jmaths.quat_from_axis_angle)(v, angle)),
    ]
    for got, want in cases:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)


def test_random_quaternion_is_unit_and_bounded():
    g = torch.Generator().manual_seed(0)
    q = tmaths.random_quaternion(4096, g, max_angle=1.0, angle_power=3.0)
    np.testing.assert_allclose(torch.linalg.norm(q, dim=-1).numpy(), 1.0, atol=1e-6)
    angle = 2 * torch.acos(q[:, 0].clamp(-1, 1))
    assert float(angle.max()) <= 1.0 + 1e-5
    # power 3 puts ~half the draws above 0.8 * max_angle (uniform: 20%)
    assert 0.4 < float((angle > 0.8).float().mean()) < 0.6


@pytest.mark.parametrize("name", ["crazyflie", "x500"])
def test_presets_match_jax(name):
    jp = to_np(getattr(jpresets, name)())
    tp = getattr(tpresets, name)()
    for f in dataclasses.fields(tp):
        np.testing.assert_array_equal(getattr(tp, f.name)[0].numpy(), getattr(jp, f.name), f.name)
    np.testing.assert_array_equal(
        tpresets.x_config_rotor_positions(0.3), jpresets.x_config_rotor_positions(0.3)
    )


def test_dynamics_match_jax(batch):
    jparams, es, tparams, tstate, n = batch
    rng = np.random.default_rng(1)
    jstate = es.dynamics
    # perturb the sampled states so rotors, velocities and spins are off hover
    jstate = jstate.replace(
        linear_velocity=jstate.linear_velocity + rng.normal(size=(n, 3)).astype(np.float32),
        angular_velocity=jstate.angular_velocity
        + 3 * rng.normal(size=(n, 3)).astype(np.float32),
        rpm=jnp.asarray(rng.uniform(0, 1, size=(n, 4)).astype(np.float32)),
    )
    tstate = state_from_numpy(to_np(jstate), "cpu")
    action = rng.uniform(-1.2, 1.2, size=(n, 4)).astype(np.float32)
    ext_f = (0.01 * rng.normal(size=(n, 3))).astype(np.float32)
    ext_t = (1e-4 * rng.normal(size=(n, 3))).astype(np.float32)

    sp_j = jax.vmap(jdyn.action_to_rpm_setpoint)(jparams, action)
    sp_t = tdyn.action_to_rpm_setpoint(tparams, t(action))
    np.testing.assert_allclose(sp_t.numpy(), np.asarray(sp_j), atol=1e-6)
    np.testing.assert_allclose(
        tdyn.rotor_thrusts(tparams, tstate.rpm).numpy(),
        np.asarray(jax.vmap(jdyn.rotor_thrusts)(jparams, jstate.rpm)), atol=1e-5,
    )
    assert_state_close(
        tdyn.derivative(tparams, tstate, sp_t, t(ext_f), t(ext_t)),
        jax.vmap(jdyn.derivative)(jparams, jstate, sp_j, ext_f, ext_t),
    )
    for method in ("rk4", "euler"):
        assert_state_close(
            tdyn.integrate(tparams, tstate, sp_t, 0.01, t(ext_f), t(ext_t), method),
            jax.vmap(lambda p, s, u, f, tq: jdyn.integrate(p, s, u, 0.01, f, tq, method))(
                jparams, jstate, sp_j, ext_f, ext_t),
        )
    nxt_t, dt = tdyn.sub_step(tparams, tstate, t(action), 0.01)
    nxt_j = jax.vmap(lambda p, s, a: jdyn.sub_step(p, s, a, 0.01)[0])(jparams, jstate, action)
    assert dt == 0.01
    assert_state_close(nxt_t, nxt_j)
    for fn in ("hover_rpm", "hover_action"):
        np.testing.assert_allclose(
            getattr(tdyn, fn)(tparams).numpy(),
            np.asarray(jax.vmap(getattr(jdyn, fn))(jparams)), atol=1e-5,
        )


def test_hover_linear_thrust_branch():
    """c2 ~ 0 takes the linear root in both packages."""
    jp = jpresets.crazyflie().replace(thrust_curve=jnp.array([0.0, 0.5, 0.0], jnp.float32))
    tp = dynamics_params_from_numpy(to_np(jp), "cpu")
    np.testing.assert_allclose(
        tdyn.hover_rpm(tp).numpy(), [float(jdyn.hover_rpm(jp))], atol=1e-7
    )


def test_golden_trajectory_reproduced():
    """artifacts/golden_trajectory.npz through the port's dynamics, starting
    from the JAX package's env.reset state (tests/test_golden_trajectory.py)."""
    data = np.load("artifacts/golden_trajectory.npz")
    jenv = JL2F(jtypes.EnvConfig())
    es, _ = jenv.reset(jax.random.key(int(data["init_key"])), jpresets.crazyflie())
    state = state_from_numpy(to_np(es.dynamics), "cpu")
    params = tpresets.crazyflie()
    env = TL2F(ttypes.EnvConfig())
    rows = []
    for a in data["actions"]:
        state, _ = env.dynamics_step(params, state, t(a)[None])
        rows.append(torch.cat([getattr(state, f)[0] for f in STATE_FIELDS]).numpy())
    np.testing.assert_allclose(np.stack(rows), data["trajectory"], atol=1e-5)


def test_observe_reward_terminated_match_jax(batch):
    jparams, es, tparams, _, n = batch
    rng = np.random.default_rng(2)
    jstate = es.dynamics
    scale = np.where(np.arange(n) % 4 == 0, 3.0, 1.0).astype(np.float32)[:, None]
    nxt = jstate.replace(
        position=jstate.position * scale,
        angular_velocity=jstate.angular_velocity + 20 * rng.normal(size=(n, 3)).astype(np.float32),
        linear_velocity=jstate.linear_velocity * np.float32(5.0),
    )
    nxt = nxt.replace(position=nxt.position.at[5, 1].set(jnp.nan))
    action = rng.uniform(-1, 1, size=(n, 4)).astype(np.float32)
    jenv = JL2F(jtypes.EnvConfig())
    env = TL2F(ttypes.EnvConfig())
    ts = state_from_numpy(to_np(jstate), "cpu")
    tn = state_from_numpy(to_np(nxt), "cpu")

    obs_j = np.asarray(jax.vmap(jenv.observe)(jparams, jstate, action))
    obs_t = env.observe(tparams, ts, t(action)).numpy()
    assert obs_t.shape == obs_j.shape == (n, 31)
    np.testing.assert_array_equal(obs_t[:, :22], obs_j[:, :22])
    np.testing.assert_allclose(obs_t[:, 22:], obs_j[:, 22:], rtol=1e-6, atol=1e-6)

    rew_j = np.asarray(jax.vmap(jenv.reward)(jparams, jstate, action, nxt))
    rew_t = env.reward(tparams, ts, t(action), tn).numpy()
    np.testing.assert_array_equal(rew_t, rew_j)

    term_j = np.asarray(jax.vmap(jenv.terminated)(jparams, nxt))
    term_t = env.terminated(tparams, tn).numpy()
    np.testing.assert_array_equal(term_t, term_j)
    assert term_t[5] and 0 < term_t.sum() < n


def test_step_with_autoreset_matches_jax(batch):
    """env.step on handed-across env states: continuing envs match JAX; envs
    at the episode cap are truncated and reset."""
    jparams, es, tparams, tstate, n = batch
    cap = jtypes.EnvConfig().episode_length
    t0 = np.where(np.arange(n) < 8, cap - 1, 3).astype(np.int32)
    jes = es.replace(t=jnp.asarray(t0))
    tes = EnvState(
        dynamics=tstate,
        action_history=t(es.action_history),
        angvel_history=t(es.angvel_history),
        t=torch.as_tensor(t0),
    )
    action = np.random.default_rng(3).uniform(-0.3, 0.3, size=(n, 4)).astype(np.float32)
    jnext, jobs, jrew, jdone, jinfo = jax.vmap(JL2F(jtypes.EnvConfig()).step)(jparams, jes, action)
    tnext, tobs, trew, tdone, tinfo = TL2F(ttypes.EnvConfig()).step(
        tparams, tes, t(action), torch.Generator().manual_seed(0)
    )
    np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone))
    np.testing.assert_array_equal(tinfo["truncated"].numpy(), np.asarray(jinfo["truncated"]))
    np.testing.assert_array_equal(tinfo["terminated"].numpy(), np.asarray(jinfo["terminated"]))
    np.testing.assert_allclose(trew.numpy(), np.asarray(jrew), atol=1e-5)
    np.testing.assert_allclose(
        tinfo["final_obs"].numpy(), np.asarray(jinfo["final_obs"]), atol=1e-5, rtol=1e-5
    )
    cont = ~np.asarray(jdone)
    assert cont.sum() > n // 2
    np.testing.assert_allclose(tobs.numpy()[cont], np.asarray(jobs)[cont], atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(tnext.t.numpy(), np.asarray(jnext.t))
    done = tdone.numpy()
    assert done[:8].all()
    np.testing.assert_array_equal(tnext.action_history.numpy()[done], 0.0)
    np.testing.assert_allclose(tnext.action_history.numpy()[cont][:, -1], action[cont])


def _moments(x):
    x = np.asarray(x, np.float64).reshape(x.shape[0], -1)
    return x.mean(0), x.std(0)


def test_population_sampler_matches_jax_distribution():
    """Same distributions, different random streams: every parameter's mean
    agrees within 5 standard errors and its spread within 15%, and the
    draws stay inside the configured ranges."""
    n = 4096
    jp = to_np(jrand.sample_population(jax.random.key(0), n))
    tp = trand.sample_population(torch.Generator().manual_seed(0), n)
    for f in dataclasses.fields(tp):
        a, b = getattr(tp, f.name).numpy(), getattr(jp, f.name)
        assert a.shape == b.shape, f.name
        (ma, sa), (mb, sb) = _moments(a), _moments(b)
        se = np.sqrt((sa**2 + sb**2) / n)
        assert np.all(np.abs(ma - mb) <= 5 * se + 1e-7), f.name
        assert np.all(np.abs(sa - sb) <= 0.15 * sb + 1e-7), f.name
    c = trand.RandomizationConfig()
    for name, lo, hi in [
        ("mass", c.mass_min, c.mass_max),
        ("motor_time_constant", c.motor_time_constant_min, c.motor_time_constant_max),
        ("rpm_min", c.rpm_min_min, c.rpm_min_max),
    ]:
        v = getattr(tp, name).numpy()
        assert lo * (1 - 1e-6) <= v.min() and v.max() <= hi * (1 + 1e-6), name
    one = trand.sample_dynamics_params(torch.Generator().manual_seed(1))
    assert one.mass.shape == (1,) and one.rotor_positions.shape == (1, 4, 3)


def test_initial_state_sampler_matches_jax_distribution():
    n = 4096
    jparams = jrand.sample_population(jax.random.key(0), n)
    cfg = jtypes.EnvConfig(init=jtypes.eval_parity_init())
    jes, _ = jax.vmap(JL2F(cfg).reset)(jax.random.split(jax.random.key(2), n), jparams)
    js = to_np(jes.dynamics)
    tparams = dynamics_params_from_numpy(to_np(jparams), "cpu")
    env = TL2F(ttypes.EnvConfig(init=ttypes.eval_parity_init()))
    tes, obs = env.reset(tparams, torch.Generator().manual_seed(2))
    assert obs.shape == (n, env.OBSERVATION_DIM)
    np.testing.assert_allclose(tes.dynamics.rpm.numpy(), js.rpm, atol=1e-6)
    for f in ("position", "linear_velocity", "angular_velocity"):
        (ma, sa), (mb, sb) = _moments(getattr(tes.dynamics, f).numpy()), _moments(getattr(js, f))
        assert np.all(np.abs(ma - mb) <= 5 * np.sqrt((sa**2 + sb**2) / n)), f
        assert np.all(np.abs(sa - sb) <= 0.1 * sb), f
    assert np.abs(tes.dynamics.position.numpy()).max() <= 0.3
    angle_t = 2 * np.arccos(np.clip(tes.dynamics.orientation[:, 0].numpy(), -1, 1))
    angle_j = 2 * np.arccos(np.clip(js.orientation[:, 0], -1, 1))
    assert angle_t.max() <= 1.0 + 1e-5
    assert abs(angle_t.mean() - angle_j.mean()) < 0.02
