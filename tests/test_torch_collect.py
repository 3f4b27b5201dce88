"""The port's fused collect (`raptor_tpu_torch.ops.collect`) held to the JAX
Pallas collect kernel and to itself.

- The counter-hash PRNG: `lowbias32` and `uniform01`, in plain PyTorch and in
  the g++ build of the kernel's header, equal `pallas_collect._lowbias32` and
  `_uniform` bit for bit; the state sampler agrees with `_sample_state_tiles`
  to 1e-6 (the normals pass through log/sqrt/cos/sin of three libraries).
- `collect_plain` against `pallas_collect.make_fused_collect` run in Pallas
  interpret mode on the CPU, from handed-across airframes, initial states and
  student weights, on three configurations: no resets, truncation every 8
  steps, a reset after every step. Reset masks equal; observations within
  atol 2e-4 (the JAX package's own tolerance, tests/test_pallas_collect.py:77)
  up to and including each env's first post-reset row, and within 1e-5 where
  every row is a fresh draw.
- The kernel's per-env code (`csrc/team_step.cuh`: `team_collect_env`, the
  lanes of a team run phase by phase), built for the CPU, against
  `collect_plain`, at the same tolerances: on the kernel's own team of
  `COLLECT_TEAM` lanes, and at hidden width 16 on teams of 1, 2, 4 and 8
  lanes, so whichever size the card is built with is covered.
- A team cannot split at a reset: envs that fly out of the position bound
  reset on the same steps as in `collect_plain`, and each row after a reset
  is the plain sampler's fresh state.
- `env_offset`, the select-based reset, the wrapper's checks and its launch
  count.
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raptor_tpu.env import EnvConfig as JEnvConfig
from raptor_tpu.env import L2F as JL2F
from raptor_tpu.env import sample_population as jsample
from raptor_tpu.env.types import InitConfig as JInitConfig
from raptor_tpu.env.types import TerminationConfig as JTerminationConfig
from raptor_tpu.ops import pallas_collect
from raptor_tpu.ops.pallas_rollout import pack_params
from raptor_tpu.policy import network as jnetwork
from raptor_tpu_torch.checkpoint import dynamics_params_from_numpy, from_numpy
from raptor_tpu_torch.checkpoint import state_from_numpy
from raptor_tpu_torch.env import EnvConfig, InitConfig, TerminationConfig, maths
from raptor_tpu_torch.env.types import DynamicsParams
from raptor_tpu_torch.ops import build
from raptor_tpu_torch.ops import collect as ops_collect
from raptor_tpu_torch.ops import eval as ops_eval
from raptor_tpu_torch.policy import network
from raptor_tpu_torch.utils.profiling import launches

N = 1024  # one full lane tile of the Pallas kernel: no padded lanes
T = 20
TEAMS = [1, 2, 4, 8]  # the lanes an env that apps/team_sweep.py measures

GENTLE = dict(max_angle=0.2, linear_velocity_std=0.02, angular_velocity_std=0.02)
WIDE = dict(position_bound=50.0, angular_velocity_bound=1000.0)
CONFIGS = {
    # name: (init kwargs, termination kwargs, episode_length, n_steps, seed)
    "no_reset": (GENTLE, WIDE, 500, T, 3),
    "truncation": (dict(max_angle=0.3, position_range=0.1, linear_velocity_std=0.02,
                        angular_velocity_std=0.02), {}, 8, T, 11),
    "every_step": (dict(max_angle=2.0, position_range=0.25, linear_velocity_std=0.15,
                        angular_velocity_std=0.1), {}, 1, 10, 5),
}


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def configs(name):
    init, term, ep_len, steps, seed = CONFIGS[name]
    jcfg = JEnvConfig(init=JInitConfig(**init), termination=JTerminationConfig(**term),
                      episode_length=ep_len)
    tcfg = EnvConfig(init=InitConfig(**init), termination=TerminationConfig(**term),
                     episode_length=ep_len)
    return jcfg, tcfg, steps, seed


@pytest.fixture(scope="module")
def student():
    p = to_np(jnetwork.init_params(jax.random.key(7)))
    return p, from_numpy(p, "cpu")


def setup(jcfg, n=N):
    """8 JAX-sampled airframes repeated over n envs and JAX-sampled initial
    states, as the JAX package's own collect tests make them, on both sides."""
    k_pop, k_reset = jax.random.split(jax.random.key(0))
    jparams = jax.tree.map(lambda x: jnp.repeat(x, n // 8, axis=0), jsample(k_pop, 8))
    es, _ = jax.vmap(JL2F(jcfg).reset)(jax.random.split(k_reset, n), jparams)
    ps = dynamics_params_from_numpy(to_np(jparams), "cpu").to_soa()
    ss = state_from_numpy(to_np(es.dynamics), "cpu").to_soa()
    return jparams, es.dynamics, ps, ss


@pytest.fixture(scope="module")
def host():
    if shutil.which("g++") is None:
        pytest.skip("g++ not found: the host build of the kernels' code needs it")
    return build.host_library()


def host_collect(lib, weights, ps, ss, n_steps, seed, env_offset, cfg, team=None):
    """The host build on the kernel's team (COLLECT_TEAM lanes), or with
    `team` on a team of that many lanes (hidden width 16 only)."""
    n = ss.shape[1]
    out = torch.empty((n_steps, ops_collect.OUT_CH, n))
    term, init = cfg.termination, cfg.init
    fn = lib.raptor_collect_host if team is None else lib.raptor_collect_team_host
    rc = fn(
        weights.data_ptr(), ps.data_ptr(), ss.data_ptr(), out.data_ptr(), n, n_steps,
        ops_eval.hidden_width(weights) if team is None else team, cfg.dt,
        float(cfg.episode_length), term.position_bound, term.linear_velocity_bound,
        term.angular_velocity_bound, init.position_range, init.max_angle, init.angle_power,
        init.linear_velocity_std, init.angular_velocity_std, int(init.rpm_at_hover), seed,
        env_offset)
    assert rc == 0
    return out[:, :22].permute(0, 2, 1), out[:, 22]


def run_impl(impl, request, student_t, ps, ss, n_steps, seed, env_offset, cfg):
    if impl == "host":
        lib = request.getfixturevalue("host")
        return host_collect(lib, ops_eval.flatten_policy(student_t), ps, ss, n_steps, seed,
                            env_offset, cfg)
    return ops_collect.collect_plain(student_t, ps, ss, n_steps, seed, env_offset, cfg)


def until_first_post_reset_row(reset):
    """[T, N] bool: rows of each env up to and including the row after its
    first reset."""
    seen = np.cumsum(np.asarray(reset), axis=0)
    before = np.concatenate([np.zeros((1, reset.shape[1])), seen[:-1]])  # resets before row t
    earlier = np.concatenate([np.zeros((1, reset.shape[1])), before[:-1]])  # ... before row t-1
    return earlier == 0


def assert_collect_close(name, got, want):
    (obs_g, reset_g), (obs_w, reset_w) = got, want
    obs_g, reset_g, obs_w, reset_w = map(np.asarray, (obs_g, reset_g, obs_w, reset_w))
    np.testing.assert_array_equal(reset_g, reset_w)
    if name == "no_reset":
        assert reset_w.sum() == 0.0
        np.testing.assert_allclose(obs_g, obs_w, atol=2e-4, rtol=0)
    elif name == "truncation":
        assert reset_w[7].mean() > 0.9 and reset_w[15].mean() > 0.9
        keep = until_first_post_reset_row(reset_w)
        assert keep[8].all() and not keep[10].any()
        np.testing.assert_allclose(obs_g[keep], obs_w[keep], atol=2e-4, rtol=0)
    else:
        assert reset_w.min() == 1.0  # every row from 1 on is a fresh draw
        np.testing.assert_allclose(obs_g, obs_w, atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# PRNG
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["plain", "host"])
def test_hash_and_uniform_equal_jax_bit_for_bit(impl, request):
    rng = np.random.default_rng(0)
    ctr = rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    ctr[:4] = [0, 1, 0xFFFFFFFF, 0x80000000]
    want_hash = np.asarray(pallas_collect._lowbias32(jnp.asarray(ctr)))
    for draw in (0, 1, 7, 13):
        want_u = np.asarray(pallas_collect._uniform(jnp.asarray(ctr), draw))
        if impl == "plain":
            c64 = torch.from_numpy(ctr.astype(np.int64))
            got_hash = ops_collect.lowbias32(c64).numpy().astype(np.uint32)
            got_u = ops_collect.uniform01(c64, draw).numpy()
        else:
            lib = request.getfixturevalue("host")
            got_hash, got_u = np.empty(4096, np.uint32), np.empty(4096, np.float32)
            lib.raptor_hash_host(ctr.ctypes.data, got_hash.ctypes.data, got_u.ctypes.data,
                                 4096, draw)
        np.testing.assert_array_equal(got_hash, want_hash)
        np.testing.assert_array_equal(got_u, want_u)  # bit for bit
        assert got_u.min() > 0.0 and got_u.max() < 1.0


def test_reset_counter_equals_the_kernel_formula():
    env_id = np.arange(5000, 5000 + 512, dtype=np.uint32)
    seed, t = 11, 377
    want = np.asarray(pallas_collect._lowbias32(
        jnp.asarray(env_id) ^ (jnp.uint32(seed) * jnp.uint32(0x85EBCA6B))
        ^ (jnp.uint32(t) * jnp.uint32(0xC2B2AE35))) * jnp.uint32(31))
    got = ops_collect.reset_counter(torch.from_numpy(env_id.astype(np.int64)), seed, t)
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)


@pytest.mark.parametrize("impl", ["plain", "host"])
@pytest.mark.parametrize("angle_power", [1.0, 3.0])
def test_sample_state_matches_pallas_sampler(impl, angle_power, request):
    """Within 1e-6: positions are exact, the rest passes through the
    transcendental functions of XLA, PyTorch and libm."""
    n = 2048
    jparams = jsample(jax.random.key(4), n)
    ps = dynamics_params_from_numpy(to_np(jparams), "cpu").to_soa()
    ctr = np.random.default_rng(1).integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    init = InitConfig(max_angle=2.0, position_range=0.25, linear_velocity_std=0.15,
                      angular_velocity_std=0.1, angle_power=angle_power)
    packed = np.asarray(pack_params(jparams)).reshape(42, -1)[:, :n]
    want = np.stack([np.asarray(x) for x in pallas_collect._sample_state_tiles(
        [jnp.asarray(row) for row in packed], jnp.asarray(ctr),
        {"position_range": init.position_range, "max_angle": init.max_angle,
         "angle_power": init.angle_power, "lv_std": init.linear_velocity_std,
         "av_std": init.angular_velocity_std, "rpm_at_hover": init.rpm_at_hover})])
    if impl == "plain":
        got = ops_collect.sample_state(
            DynamicsParams.from_soa(ps), torch.from_numpy(ctr.astype(np.int64)), init
        ).to_soa().numpy()
    else:
        lib = request.getfixturevalue("host")
        got = np.empty((17, n), np.float32)
        lib.raptor_sample_state_host(
            ps.data_ptr(), ctr.ctypes.data, got.ctypes.data, n, init.position_range,
            init.max_angle, init.angle_power, init.linear_velocity_std,
            init.angular_velocity_std, int(init.rpm_at_hover))
    np.testing.assert_array_equal(got[0:3], want[0:3])
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(got[3:7], axis=0), 1.0, atol=1e-6)


# ---------------------------------------------------------------------------
# the rollout
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pallas_runs(student):
    """The JAX kernel in interpret mode on each configuration, with the
    handed-across inputs: name -> (torch cfg, steps, seed, ps, ss, obs, reset)."""
    out = {}
    for name in CONFIGS:
        jcfg, tcfg, steps, seed = configs(name)
        jparams, jstate, ps, ss = setup(jcfg)
        obs, reset = pallas_collect.make_fused_collect(student[0], steps, jcfg, chunk=5)(
            jparams, jstate, seed)
        out[name] = (tcfg, steps, seed, ps, ss, np.asarray(obs), np.asarray(reset))
    return out


@pytest.mark.parametrize("name", list(CONFIGS))
def test_collect_plain_matches_pallas_interpret(pallas_runs, student, name):
    tcfg, steps, seed, ps, ss, obs, reset = pallas_runs[name]
    got = ops_collect.collect_soa(ops_eval.flatten_policy(student[1]), ps, ss, steps, seed, 0,
                                  tcfg)
    assert got[0].shape == (steps, N, 22) and got[1].shape == (steps, N)
    assert_collect_close(name, got, (obs, reset))


@pytest.fixture(scope="module")
def plain_runs(pallas_runs, student):
    """collect_plain on each configuration: name -> (obs, reset)."""
    out = {}
    for name, (tcfg, steps, seed, ps, ss, _, _) in pallas_runs.items():
        out[name] = ops_collect.collect_plain(student[1], ps, ss, steps, seed, 0, tcfg)
    return out


@pytest.mark.parametrize("name", list(CONFIGS))
def test_host_build_of_collect_kernel_matches_plain(pallas_runs, plain_runs, student, host,
                                                    name):
    tcfg, steps, seed, ps, ss, _, _ = pallas_runs[name]
    weights = ops_eval.flatten_policy(student[1])
    assert_collect_close(
        name, host_collect(host, weights, ps, ss, steps, seed, 0, tcfg), plain_runs[name])


@pytest.mark.parametrize("team", TEAMS)
@pytest.mark.parametrize("name", list(CONFIGS))
def test_host_build_at_team_size_matches_plain(pallas_runs, plain_runs, student, host, name,
                                               team):
    """Hidden width 16 on a team of 1, 2, 4 or 8 lanes: the policy split
    over U = 16, 8, 4 or 2 units a lane, the rotors over 1, 2 or 4 lanes."""
    tcfg, steps, seed, ps, ss, _, _ = pallas_runs[name]
    weights = ops_eval.flatten_policy(student[1])
    assert_collect_close(
        name, host_collect(host, weights, ps, ss, steps, seed, 0, tcfg, team=team),
        plain_runs[name])


@pytest.mark.parametrize("team", TEAMS)
def test_team_cannot_split_at_the_termination_boundary(pallas_runs, student, host, team):
    """Every env starts level, at rest, 0.5 to 11.5 mm inside the position
    bound and flying out of it at 0.1 to 0.4 m/s, so it crosses the bound
    within a few steps and resets. The team's done flag comes from lane 0 and
    every lane draws the fresh state from the same counter: the reset masks
    must equal the plain version's exactly, and each row after a reset must be
    the plain sampler's fresh state (its observation, previous action 0) to
    1e-6."""
    _, _, _, ps, ss, _, _ = pallas_runs["no_reset"]
    tcfg = EnvConfig(init=InitConfig(**GENTLE))  # default bounds
    edge = ss.clone()
    k = torch.arange(N, dtype=torch.float32)
    edge[0:3] = 0.0
    edge[0] = 0.6 - 1e-3 * ((k * 0.618) % 1.0 * 11.0 + 0.5)
    edge[3:7] = torch.tensor([1.0, 0.0, 0.0, 0.0])[:, None]
    edge[7:13] = 0.0
    edge[7] = 0.1 + 0.3 * ((k * 0.414) % 1.0)
    steps, seed = 30, 9
    weights = ops_eval.flatten_policy(student[1])
    obs, reset = host_collect(host, weights, ps, edge, steps, seed, 0, tcfg, team=team)
    ref_obs, ref_reset = ops_collect.collect_plain(student[1], ps, edge, steps, seed, 0, tcfg)
    np.testing.assert_array_equal(reset.numpy(), ref_reset.numpy())
    crossed = (reset[:-1].sum(0) >= 1).float().mean()
    assert float(crossed) > 0.9, float(crossed)  # most envs crossed the bound and reset
    for t in range(steps - 1):
        (envs,) = torch.nonzero(reset[t] == 1.0, as_tuple=True)
        if envs.numel() == 0:
            continue
        fresh = ops_collect.sample_state(
            DynamicsParams.from_soa(ps[:, envs]),
            ops_collect.reset_counter(envs.to(torch.int64), seed, t), tcfg.init)
        want = torch.cat([fresh.position, maths.quat_to_rotm(fresh.orientation).reshape(-1, 9),
                          fresh.linear_velocity, fresh.angular_velocity,
                          torch.zeros((envs.numel(), 4))], -1)
        np.testing.assert_allclose(obs[t + 1, envs].numpy(), want.numpy(), atol=1e-6, rtol=0)
        np.testing.assert_allclose(ref_obs[t + 1, envs].numpy(), want.numpy(), atol=1e-6,
                                   rtol=0)


def test_post_reset_rows_come_from_the_init_distribution(pallas_runs, student):
    tcfg, steps, seed, ps, ss, _, _ = pallas_runs["truncation"]
    obs, reset = ops_collect.collect_plain(student[1], ps, ss, steps, seed, 0, tcfg)
    t, e = np.nonzero(reset[:-1].numpy())
    after = obs.numpy()[t + 1, e]
    assert after.shape[0] > N
    assert np.all(np.abs(after[:, 0:3]) <= tcfg.init.position_range + 1e-6)
    assert np.max(np.abs(after[:, 18:22])) == 0.0  # previous action restarts at zero
    rot = after[:, 3:12].reshape(-1, 3, 3)
    np.testing.assert_allclose(np.einsum("nij,nkj->nik", rot, rot),
                               np.broadcast_to(np.eye(3), rot.shape), atol=1e-4)
    angle = np.arccos(np.clip((np.einsum("nii->n", rot) - 1.0) / 2.0, -1.0, 1.0))
    assert np.max(angle) <= tcfg.init.max_angle + 1e-4


@pytest.mark.parametrize("impl", ["plain", "host"])
def test_env_offset_split_equals_the_whole(pallas_runs, student, impl, request):
    """Two half-size launches with offsets 0 and N/2 reproduce the full one
    exactly: env ids, not launch-local indices, key the reset stream."""
    tcfg, steps, seed, ps, ss, _, _ = pallas_runs["every_step"]
    half = N // 2
    whole = run_impl(impl, request, student[1], ps, ss, steps, seed, 0, tcfg)
    parts = [
        run_impl(impl, request, student[1], ps[:, lo:lo + half].contiguous(),
                 ss[:, lo:lo + half].contiguous(), steps, seed, lo, tcfg)
        for lo in (0, half)
    ]
    for i in (0, 1):
        np.testing.assert_array_equal(
            np.concatenate([np.asarray(p[i]) for p in parts], axis=1), np.asarray(whole[i]))
    # and without the offset the second half would repeat the first half's draws
    again = run_impl(impl, request, student[1], ps[:, half:].contiguous(),
                     ss[:, half:].contiguous(), steps, seed, 0, tcfg)
    assert not np.array_equal(np.asarray(again[0][2:]), np.asarray(parts[1][0][2:]))


@pytest.mark.parametrize("impl", ["plain", "host"])
def test_nan_state_resets_its_env_only(pallas_runs, student, impl, request):
    tcfg, steps, seed, ps, ss, _, _ = pallas_runs["no_reset"]
    bad = ss.clone()
    bad[1, 3] = float("nan")  # env 3: non-finite position
    obs, reset = run_impl(impl, request, student[1], ps, bad, steps, seed, 0, tcfg)
    ref_obs, ref_reset = run_impl(impl, request, student[1], ps, ss, steps, seed, 0, tcfg)
    obs, reset, ref_obs, ref_reset = map(np.asarray, (obs, reset, ref_obs, ref_reset))
    assert reset[0, 3] == 1.0 and reset[1:, 3].sum() == 0.0
    assert np.isnan(obs[0, 3, 1]) and np.all(np.isfinite(obs[1:, 3]))  # really replaced
    others = np.arange(N) != 3
    np.testing.assert_array_equal(obs[:, others], ref_obs[:, others])
    np.testing.assert_array_equal(reset[:, others], ref_reset[:, others])


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fault", ["dtype", "shape", "layout", "weights", "device",
                                   "action_history", "angvel_delay"])
def test_wrapper_rejects_bad_inputs(pallas_runs, student, fault):
    from raptor_tpu_torch.env import ObservationConfig

    tcfg, _, _, ps, ss, _, _ = pallas_runs["no_reset"]
    weights = ops_eval.flatten_policy(student[1])
    args, cfg = [weights, ps, ss], tcfg
    if fault == "dtype":
        args[1] = ps.double()
    elif fault == "shape":
        args[1] = ps[:, :-1].contiguous()
    elif fault == "layout":
        args[2] = ss.T.contiguous().T
    elif fault == "weights":
        args[0] = weights[:-1]
    elif fault == "device":
        args[1] = ps.to("meta")
    elif fault == "action_history":
        cfg = EnvConfig(observation=ObservationConfig(action_history_length=2))
    else:
        cfg = EnvConfig(observation=ObservationConfig(angular_velocity_delay=1))
    with pytest.raises(ValueError):
        ops_collect.collect_soa(*args, 2, 0, 0, cfg)


def test_fused_collect_rejects_other_widths(pallas_runs):
    tcfg, _, _, ps, ss, _, _ = pallas_runs["no_reset"]
    wide = network.init_params(torch.Generator().manual_seed(0), hidden_dim=20)
    with pytest.raises(ValueError, match=r"hidden widths \(8, 16, 24, 32, 48\)"):
        ops_collect.make_fused_collect(wide, 4, tcfg, device="cpu")
    for hidden in (8, 24, 32, 48):  # the widths the kernel is built for
        built = network.init_params(torch.Generator().manual_seed(0), hidden_dim=hidden)
        ops_collect.make_fused_collect(built, 4, tcfg, device="cpu")


def test_cpu_call_runs_plain_without_counting(pallas_runs, student):
    tcfg, _, seed, ps, ss, _, _ = pallas_runs["truncation"]
    before = launches["collect"]
    from raptor_tpu_torch.env.types import DynamicsParams as DP
    from raptor_tpu_torch.env.types import State

    got = ops_collect.fused_collect(student[1], DP.from_soa(ps), State.from_soa(ss), 12, seed,
                                    config=tcfg, device="cpu")
    want = ops_collect.collect_plain(student[1], ps, ss, 12, seed, 0, tcfg)
    np.testing.assert_array_equal(got[0].numpy(), want[0].numpy())
    np.testing.assert_array_equal(got[1].numpy(), want[1].numpy())
    assert launches["collect"] == before
