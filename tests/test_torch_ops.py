"""The port's fused kernels (`raptor_tpu_torch.ops`) held to the JAX Pallas
kernels and to each other.

- The plain PyTorch versions against `pallas_rollout.fused_rollout` and
  `pallas_eval.fused_policy_eval` run in Pallas interpret mode on the CPU, at
  the JAX package's own tolerances (tests/test_pallas_rollout.py:55-68,
  tests/test_pallas_eval.py:72-83).
- The kernels' per-env code (`csrc/quad_step.cuh`), built for the CPU with
  g++ through `csrc/host_shim.cpp`, against the plain versions: the
  arithmetic the CUDA kernels run, checked off the card.
- The select-based freeze: a NaN state ends its env and touches no other.
- A team of lanes cannot split: near the termination boundary alive, length
  and every state row agree with the plain version.
"""

import shutil

import jax
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from raptor_tpu.env import EnvConfig as JEnvConfig
from raptor_tpu.env import L2F as JL2F
from raptor_tpu.env import sample_population as jsample
from raptor_tpu.ops import pallas_eval, pallas_rollout
from raptor_tpu_torch.checkpoint import dynamics_params_from_numpy, from_numpy, h5
from raptor_tpu_torch.checkpoint import state_from_numpy
from raptor_tpu_torch.env import dynamics
from raptor_tpu_torch.env.types import DynamicsParams, State
from raptor_tpu_torch.ops import build
from raptor_tpu_torch.ops import eval as ops_eval
from raptor_tpu_torch.ops import rollout as ops_rollout
from raptor_tpu_torch.policy import network
from raptor_tpu_torch.utils.profiling import launches

N = 128
NPZ = "raptor_tpu_torch/data/student_rateFlagCurMix.npz"
OFF = dict(pos_bound=1e9, linvel_bound=1e9, angvel_bound=1e9)
ACTION = np.array([0.1, -0.05, 0.02, 0.0], np.float32)


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def batch():
    """128 JAX-sampled airframes and initial states (default init: attitudes
    up to pi, so some envs terminate within the eval horizon)."""
    jparams = jsample(jax.random.key(0), N)
    es, _ = jax.vmap(JL2F(JEnvConfig()).reset)(jax.random.split(jax.random.key(1), N), jparams)
    tparams = dynamics_params_from_numpy(to_np(jparams), "cpu")
    tstate = state_from_numpy(to_np(es.dynamics), "cpu")
    return jparams, es.dynamics, tparams.to_soa(), tstate.to_soa()


@pytest.fixture(scope="module")
def policy():
    p = h5.load_actor(NPZ)
    return p, from_numpy(p, "cpu")


@pytest.fixture(scope="module")
def host():
    if shutil.which("g++") is None:
        pytest.skip("g++ not found: the host build of the kernels' code needs it")
    return build.host_library()


def host_rollout(lib, ps, ss, act, n_steps, pos_bound=0.6, linvel_bound=1000.0,
                 angvel_bound=35.0):
    out, stats = torch.empty_like(ss), torch.empty((2, ss.shape[1]))
    lib.raptor_rollout_host(ps.data_ptr(), ss.data_ptr(), act.data_ptr(), out.data_ptr(),
                            stats.data_ptr(), ss.shape[1], n_steps, 0.01, pos_bound,
                            linvel_bound, angvel_bound)
    return out, stats


def host_eval(lib, weights, ps, ss, n_steps, pos_bound=0.6):
    out, stats = torch.empty_like(ss), torch.empty((3, ss.shape[1]))
    rc = lib.raptor_eval_host(weights.data_ptr(), ps.data_ptr(), ss.data_ptr(), out.data_ptr(),
                              stats.data_ptr(), ss.shape[1], n_steps,
                              ops_eval.hidden_width(weights), 0.01, pos_bound, 1000.0, 35.0,
                              *ops_eval._reward_args(ops_eval.RewardConfig()))
    assert rc == 0
    return out, stats


def const_action(n):
    return torch.from_numpy(ACTION)[:, None].expand(4, n).contiguous()


def assert_eval_close(got, want):
    """(state [17, N] or position [3, N], stats [3, N]) pairs at the closed-loop
    tolerances of tests/test_pallas_eval.py:76-83: alive and length exact."""
    (s_g, st_g), (s_w, st_w) = got, want
    np.testing.assert_array_equal(st_g[0].numpy(), st_w[0].numpy())
    np.testing.assert_array_equal(st_g[1].numpy(), st_w[1].numpy())
    np.testing.assert_allclose(st_g[2].numpy(), st_w[2].numpy(), atol=5e-3, rtol=1e-3)
    np.testing.assert_allclose(s_g[0:3].numpy(), s_w[0:3].numpy(), atol=1e-3)


def test_soa_layout_matches_pallas_packing(batch):
    jparams, jstate, ps, ss = batch
    np.testing.assert_array_equal(
        ps.numpy(), np.asarray(pallas_rollout.pack_params(jparams)).reshape(42, -1)[:, :N])
    np.testing.assert_array_equal(
        ss.numpy(), np.asarray(pallas_rollout.pack_state(jstate)).reshape(17, -1)[:, :N])
    np.testing.assert_array_equal(State.from_soa(ss).to_soa().numpy(), ss.numpy())
    np.testing.assert_array_equal(DynamicsParams.from_soa(ps).to_soa().numpy(), ps.numpy())


@pytest.mark.parametrize("bounds", ["off", "default"])
def test_rollout_plain_matches_pallas_interpret(batch, bounds):
    jparams, jstate, ps, ss = batch
    steps = 20
    kw = OFF if bounds == "off" else {}
    with pltpu.force_tpu_interpret_mode():
        ref, alive, length = pallas_rollout.fused_rollout(
            jparams, jstate, np.tile(ACTION, (N, 1)), steps,
            **{k: v for k, v in kw.items() if k != "linvel_bound"})
    out, stats = ops_rollout.rollout_soa(ps, ss, const_action(N), steps, **kw)
    np.testing.assert_array_equal(stats[0].numpy(), np.asarray(alive))
    np.testing.assert_array_equal(stats[1].numpy(), np.asarray(length))
    if bounds == "off":
        assert bool((stats[0] == 1).all())
    else:
        assert 0 < int(stats[0].sum()) < N
    got = State.from_soa(out)
    for name in ["position", "orientation", "linear_velocity", "angular_velocity", "rpm"]:
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                   atol=2e-4, rtol=1e-3, err_msg=name)


def test_eval_plain_matches_pallas_interpret(batch, policy):
    jparams, jstate, ps, ss = batch
    p_np, p_t = policy
    with pltpu.force_tpu_interpret_mode():
        s, alive, length, ret = pallas_eval.fused_policy_eval(p_np, jparams, jstate, 25)
    ref = (
        torch.from_numpy(np.asarray(s.position).T.copy()),
        torch.from_numpy(np.stack([np.asarray(alive), np.asarray(length), np.asarray(ret)])),
    )
    got = ops_eval.eval_soa(ops_eval.flatten_policy(p_t), ps, ss, 25)
    assert_eval_close(got, ref)
    assert 0 < int(got[1][0].sum()) < N  # some envs terminated, some flew on


@pytest.mark.parametrize("bounds", ["off", "default"])
def test_host_build_of_rollout_kernel_matches_plain(batch, host, bounds):
    _, _, ps, ss = batch
    kw = OFF if bounds == "off" else {}
    steps = 20 if bounds == "off" else 60
    out, stats = host_rollout(host, ps, ss, const_action(N), steps, **kw)
    ref_out, ref_stats = ops_rollout.rollout_plain(ps, ss, const_action(N), steps, **kw)
    np.testing.assert_array_equal(stats.numpy(), ref_stats.numpy())
    np.testing.assert_allclose(out.numpy(), ref_out.numpy(), atol=2e-4, rtol=1e-3)


def test_host_build_of_eval_kernel_matches_plain(batch, policy, host):
    _, _, ps, ss = batch
    weights = ops_eval.flatten_policy(policy[1])
    assert_eval_close(host_eval(host, weights, ps, ss, 25),
                      ops_eval.eval_plain(policy[1], ps, ss, 25))


@pytest.mark.parametrize("impl", ["plain", "host"])
@pytest.mark.parametrize("kernel", ["rollout", "eval"])
def test_nan_state_ends_its_env_only(batch, policy, request, impl, kernel):
    _, _, ps, ss = batch
    bad = ss.clone()
    bad[1, 3] = float("nan")  # env 3: non-finite position
    if kernel == "rollout":
        if impl == "host":
            lib = request.getfixturevalue("host")
            run = lambda s: host_rollout(lib, ps, s, const_action(N), 30)  # noqa: E731
        else:
            run = lambda s: ops_rollout.rollout_plain(ps, s, const_action(N), 30)  # noqa: E731
    else:
        weights = ops_eval.flatten_policy(policy[1])
        if impl == "host":
            lib = request.getfixturevalue("host")
            run = lambda s: host_eval(lib, weights, ps, s, 30)  # noqa: E731
        else:
            run = lambda s: ops_eval.eval_plain(policy[1], ps, s, 30)  # noqa: E731
    out, stats = run(bad)
    ref_out, ref_stats = run(ss)
    assert float(stats[0, 3]) == 0.0 and float(stats[1, 3]) == 1.0
    np.testing.assert_array_equal(out[:, 3].numpy(), bad[:, 3].numpy())  # pre-step state
    others = np.arange(N) != 3
    np.testing.assert_array_equal(out[:, others].numpy(), ref_out[:, others].numpy())
    np.testing.assert_array_equal(stats[:, others].numpy(), ref_stats[:, others].numpy())


@pytest.mark.parametrize("kernel", ["rollout", "eval"])
def test_team_cannot_split_at_the_termination_boundary(batch, policy, host, kernel):
    """Every env starts level, at rest, 0.5 to 11.5 mm inside the position
    bound and flying out of it at 0.1 to 0.4 m/s, so it crosses the bound
    within a few steps. The team's done flag comes from one lane: alive,
    length and all 17 state rows (the rotor rows come from the lanes that own
    the rotors) must equal the plain version's."""
    _, _, ps, ss = batch
    edge = ss.clone()
    k = torch.arange(N, dtype=torch.float32)
    edge[0:3] = 0.0
    edge[0] = 0.6 - 1e-3 * ((k * 0.618) % 1.0 * 11.0 + 0.5)
    edge[3:7] = torch.tensor([1.0, 0.0, 0.0, 0.0])[:, None]
    edge[7:13] = 0.0
    edge[7] = 0.1 + 0.3 * ((k * 0.414) % 1.0)
    steps = 40
    if kernel == "rollout":
        hover = dynamics.hover_action(DynamicsParams.from_soa(ps))
        act = hover[None].expand(4, N).contiguous()
        got = host_rollout(host, ps, edge, act, steps)
        want = ops_rollout.rollout_plain(ps, edge, act, steps)
    else:
        got = host_eval(host, ops_eval.flatten_policy(policy[1]), ps, edge, steps)
        want = ops_eval.eval_plain(policy[1], ps, edge, steps)
    np.testing.assert_array_equal(got[1][:2].numpy(), want[1][:2].numpy())
    assert float(got[1][0].sum()) == 0.0 and float(got[1][1].max()) < steps
    np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), atol=2e-4, rtol=1e-3)


def test_fused_eval_rejects_other_widths(batch):
    _, _, ps, ss = batch
    wide = network.init_params(torch.Generator().manual_seed(0), hidden_dim=20)
    with pytest.raises(ValueError, match=r"hidden widths \(8, 16, 24, 32, 48\)"):
        ops_eval.make_fused_policy_eval(wide, 4, device="cpu")
    with pytest.raises(ValueError, match=r"hidden widths \(8, 16, 24, 32, 48\)"):
        ops_eval.eval_soa(ops_eval.flatten_policy(wide), ps, ss, 4)
    # eval_plain serves any width
    stats = ops_eval.eval_plain(wide, ps, ss, 4)[1]
    assert stats.shape == (3, N) and bool(torch.isfinite(stats).all())


def test_wrappers_run_plain_on_cpu_without_counting(batch, policy):
    _, _, ps, ss = batch
    before = (launches["rollout"], launches["eval"])
    out, stats = ops_rollout.rollout_soa(ps, ss, const_action(N), 5)
    ref = ops_rollout.rollout_plain(ps, ss, const_action(N), 5)
    np.testing.assert_array_equal(out.numpy(), ref[0].numpy())
    ops_eval.eval_soa(ops_eval.flatten_policy(policy[1]), ps, ss, 3)
    assert (launches["rollout"], launches["eval"]) == before


@pytest.mark.parametrize("fault", ["dtype", "shape", "layout", "weights"])
def test_wrappers_reject_bad_inputs(batch, policy, fault):
    _, _, ps, ss = batch
    weights = ops_eval.flatten_policy(policy[1])
    act = const_action(N)
    if fault == "dtype":
        args = (ps.double(), ss, act)
    elif fault == "shape":
        args = (ps[:, :-1].contiguous(), ss, act)
    elif fault == "layout":
        args = (ps, ss, act.T.contiguous().T)
    with pytest.raises(ValueError):
        if fault == "weights":
            ops_eval.eval_soa(weights[:-1], ps, ss, 1)
        else:
            ops_rollout.rollout_soa(*args, 1)
