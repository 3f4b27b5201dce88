"""The port's scripted recovery controller (`env.recovery`, batched over the
env axis) against `jax.vmap` of the JAX package's per-env functions, on
airframes sampled by the JAX package and states made with numpy from a seed.

Tolerance 1e-5 (absolute): both sides are f32 on the CPU; the action passes
through a 4x4 linear solve and a square root, whose rounding differs between
LAPACK builds. Actions are in [-1, 1].
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raptor_tpu.env import sample_population as jsample
from raptor_tpu.env import recovery as jrecovery
from raptor_tpu.env.types import State as JState
from raptor_tpu_torch.checkpoint import dynamics_params_from_numpy, state_from_numpy
from raptor_tpu_torch.env import recovery

N = 256
ATOL = 1e-5
PURE = dict(adaptive=True, w_cap=999.0, k_w=999.0, c_flip=0.5, c_lag=1.2, c_bw=3.0)


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def airframes():
    jparams = jsample(jax.random.key(11), N)
    return jparams, dynamics_params_from_numpy(to_np(jparams), "cpu")


def quat_about(axis, angle):
    axis = axis / np.linalg.norm(axis, axis=-1, keepdims=True)
    return np.concatenate([np.cos(angle / 2)[:, None], axis * np.sin(angle / 2)[:, None]], -1)


def make_states(kind, rng):
    """numpy state fields [N, ...] of one kind of attitude."""
    if kind == "random":
        q = rng.normal(0, 1, (N, 4))
        q /= np.linalg.norm(q, axis=-1, keepdims=True)
    elif kind == "upright":
        q = np.tile([1.0, 0.0, 0.0, 0.0], (N, 1))
    elif kind == "inverted":  # past the tilt gate: the target is world up
        axis = rng.normal(0, 1, (N, 3))
        axis[:, 2] = 0.0
        q = quat_about(axis, rng.uniform(2.0, 3.1, N))
    else:  # anti-parallel: body z exactly opposite to world up, cross product vanishes
        q = np.tile([0.0, 1.0, 0.0, 0.0], (N, 1))
        q[N // 2:] = [0.0, 0.0, 1.0, 0.0]
    still = kind == "anti_parallel"
    fields = dict(
        position=np.zeros((N, 3)) if still else rng.normal(0, 0.3, (N, 3)),
        orientation=q,
        linear_velocity=np.zeros((N, 3)) if still else rng.normal(0, 0.5, (N, 3)),
        angular_velocity=rng.normal(0, 3.0, (N, 3)),
        rpm=rng.uniform(0.2, 0.9, (N, 4)),
    )
    return {k: v.astype(np.float32) for k, v in fields.items()}


def both_states(kind, seed):
    fields = make_states(kind, np.random.default_rng(seed))
    jstate = JState(**{k: jnp.asarray(v) for k, v in fields.items()})
    return jstate, state_from_numpy(fields, "cpu")


@pytest.mark.parametrize("kind", ["random", "upright", "inverted", "anti_parallel"])
def test_tilt_angle_matches_jax(kind):
    jstate, tstate = both_states(kind, 0)
    want = np.asarray(jax.vmap(jrecovery.tilt_angle)(jstate.orientation))
    got = recovery.tilt_angle(tstate.orientation).numpy()
    assert got.shape == (N,)
    # 5e-4 only where acos is steep: near tilt 0 and pi an f32 ulp of R22 moves the angle
    # by sqrt(2 ulp) ~ 3.5e-4; elsewhere 1e-5
    steep = np.abs(np.cos(want)) > 0.999
    np.testing.assert_allclose(got[~steep], want[~steep], atol=ATOL, rtol=0)
    np.testing.assert_allclose(got[steep], want[steep], atol=5e-4, rtol=0)
    if kind == "upright":
        assert np.all(got == 0.0)
    if kind == "anti_parallel":
        np.testing.assert_allclose(got, np.pi, atol=1e-6)


@pytest.mark.parametrize("gains", [(10.0, 30.0, 1.0, 0.8, 1.5), (999.0, 999.0, 0.5, 1.2, 3.0),
                                   (6.0, 12.0, 0.65, 0.8, 2.0)])
def test_adaptive_gain_caps_match_jax(airframes, gains):
    jparams, tparams = airframes
    w_j, k_j = jax.vmap(lambda p: jrecovery.adaptive_gain_caps(p, *gains))(jparams)
    w_t, k_t = recovery.adaptive_gain_caps(tparams, *gains)
    assert w_t.shape == (N,) and k_t.shape == (N,)
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=1e-5, atol=ATOL)
    np.testing.assert_allclose(k_t.numpy(), np.asarray(k_j), rtol=1e-5, atol=ATOL)
    assert float(w_t.max()) <= gains[0] and float(k_t.max()) <= gains[1]
    assert float(w_t.min()) > 0.0


@pytest.mark.parametrize("kind", ["random", "upright", "inverted", "anti_parallel"])
@pytest.mark.parametrize("gains", ["fixed", "adaptive", "physics_pure", "soft"])
def test_recovery_action_matches_jax(airframes, kind, gains):
    jparams, tparams = airframes
    jstate, tstate = both_states(kind, 1)
    kwargs = {
        "fixed": {},
        "adaptive": dict(adaptive=True),
        "physics_pure": PURE,
        "soft": dict(k_theta=4.0, w_cap=5.0, k_w=12.0, kp_p=3.0, kd_p=2.0, tilt_gate=0.8),
    }[gains]
    want = np.asarray(
        jax.vmap(functools.partial(jrecovery.recovery_action, **kwargs))(jparams, jstate))
    got = recovery.recovery_action(tparams, tstate, **kwargs).numpy()
    assert got.shape == (N, 4)
    assert np.all(np.isfinite(got)) and np.max(np.abs(got)) <= 1.0
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert np.std(got) > 0.05  # not a saturated constant


def test_recovery_action_rights_an_inverted_airframe(airframes):
    """Closed loop in the port's env: flown by the scripted controller from
    inverted starts, most airframes end upright."""
    from raptor_tpu_torch.env import EnvConfig, L2F

    _, tparams = airframes
    _, state = both_states("inverted", 2)
    env = L2F(EnvConfig())
    tilt0 = recovery.tilt_angle(state.orientation)
    for _ in range(150):
        action = recovery.recovery_action(tparams, state, **PURE)
        state, _ = env.dynamics_step(tparams, state, action)
    tilt1 = recovery.tilt_angle(state.orientation)
    assert float(tilt0.min()) > 1.9
    assert float((tilt1 < 0.5).float().mean()) > 0.6
