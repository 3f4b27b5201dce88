"""The port's eval and collect kernels at the hidden widths they are built for
(`ops.eval.HIDDEN_WIDTHS`), held to the JAX Pallas kernels on the CPU.

- The host build of the eval kernel's team code (`csrc/team_step.cuh`, the K
  lanes of a team run phase by phase) at widths 8, 24, 32 and 48 against
  `pallas_eval.fused_policy_eval` in interpret mode, 25 steps, on students of
  `raptor_tpu.policy.network.init_params(key, hidden_dim=H)`: alive and length
  equal, return within 5e-3 / 1e-3, position within 1e-3 (the tolerances of
  tests/test_pallas_eval.py:76-83). Width 16 is tests/test_torch_ops.py's.
- The host build of the collect kernel's team code (`team_collect_env`, on
  the kernel's team of `COLLECT_TEAM` lanes) at widths 24 and 32 against `pallas_collect.make_fused_collect` in interpret
  mode, on tests/test_torch_collect.py's truncation configuration (a reset
  every 8 steps, so the hidden state restarts from h0) at that file's
  tolerances: reset masks equal, observations within 2e-4 up to each env's
  first post-reset row.
- A width the kernels are not built for raises ValueError naming the built
  ones, in the host build as in the wrappers.
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from raptor_tpu.env import EnvConfig as JEnvConfig
from raptor_tpu.env import L2F as JL2F
from raptor_tpu.env import sample_population as jsample
from raptor_tpu.env.types import InitConfig as JInitConfig
from raptor_tpu.ops import pallas_collect, pallas_eval
from raptor_tpu.policy import network as jnetwork
from raptor_tpu_torch.checkpoint import dynamics_params_from_numpy, from_numpy
from raptor_tpu_torch.checkpoint import state_from_numpy
from raptor_tpu_torch.env import EnvConfig, InitConfig
from raptor_tpu_torch.ops import build
from raptor_tpu_torch.ops import collect as ops_collect
from raptor_tpu_torch.ops import eval as ops_eval

N_EVAL = 128
N_COLLECT = 1024  # one full lane tile of the Pallas kernel: no padded lanes


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def host():
    if shutil.which("g++") is None:
        pytest.skip("g++ not found: the host build of the kernels' code needs it")
    return build.host_library()


def student(hidden):
    """A JAX-initialized student of a hidden width, on both sides, with
    biases and h0 drawn from N(0, 0.1) (init_params leaves them at 0), so the
    layout of every part is checked."""
    p = to_np(jnetwork.init_params(jax.random.key(hidden), hidden_dim=hidden))
    rng = np.random.default_rng(hidden)
    for layer, name in (("dense_0", "biases"), ("gru_1", "biases_input"),
                        ("gru_1", "biases_hidden"), ("gru_1", "initial_hidden_state"),
                        ("dense_2", "biases")):
        p[layer][name] = rng.normal(0.0, 0.1, p[layer][name].shape).astype(np.float32)
    return p, from_numpy(p, "cpu")


def host_eval(lib, weights, ps, ss, n_steps):
    out, stats = torch.empty_like(ss), torch.empty((3, ss.shape[1]))
    rc = lib.raptor_eval_host(weights.data_ptr(), ps.data_ptr(), ss.data_ptr(), out.data_ptr(),
                              stats.data_ptr(), ss.shape[1], n_steps,
                              ops_eval.hidden_width(weights), 0.01, 0.6, 1000.0, 35.0,
                              *ops_eval._reward_args(ops_eval.RewardConfig()))
    return rc, out, stats


@pytest.mark.parametrize("hidden", [8, 24, 32, 48])
def test_host_build_of_eval_kernel_matches_pallas_at_width(host, hidden):
    jparams = jsample(jax.random.key(0), N_EVAL)
    es, _ = jax.vmap(JL2F(JEnvConfig()).reset)(
        jax.random.split(jax.random.key(1), N_EVAL), jparams)
    ps = dynamics_params_from_numpy(to_np(jparams), "cpu").to_soa()
    ss = state_from_numpy(to_np(es.dynamics), "cpu").to_soa()
    p_np, p_t = student(hidden)
    with pltpu.force_tpu_interpret_mode():
        s, alive, length, ret = pallas_eval.fused_policy_eval(p_np, jparams, es.dynamics, 25)
    rc, out, stats = host_eval(host, ops_eval.flatten_policy(p_t), ps, ss, 25)
    assert rc == 0
    np.testing.assert_array_equal(stats[0].numpy(), np.asarray(alive))
    np.testing.assert_array_equal(stats[1].numpy(), np.asarray(length))
    np.testing.assert_allclose(stats[2].numpy(), np.asarray(ret), atol=5e-3, rtol=1e-3)
    np.testing.assert_allclose(out[0:3].numpy(), np.asarray(s.position).T, atol=1e-3)
    assert 0 < int(stats[0].sum()) < N_EVAL  # some envs terminated, some flew on


def truncation():
    """(JAX config, torch config) of tests/test_torch_collect.py's truncation
    configuration."""
    init = dict(max_angle=0.3, position_range=0.1, linear_velocity_std=0.02,
                angular_velocity_std=0.02)
    return (JEnvConfig(init=JInitConfig(**init), episode_length=8),
            EnvConfig(init=InitConfig(**init), episode_length=8))


def host_collect(lib, weights, ps, ss, n_steps, seed, cfg):
    n = ss.shape[1]
    out = torch.empty((n_steps, ops_collect.OUT_CH, n))
    term, init = cfg.termination, cfg.init
    rc = lib.raptor_collect_host(
        weights.data_ptr(), ps.data_ptr(), ss.data_ptr(), out.data_ptr(), n, n_steps,
        ops_eval.hidden_width(weights), cfg.dt, float(cfg.episode_length), term.position_bound,
        term.linear_velocity_bound, term.angular_velocity_bound, init.position_range,
        init.max_angle, init.angle_power, init.linear_velocity_std, init.angular_velocity_std,
        int(init.rpm_at_hover), seed, 0)
    return rc, out[:, :22].permute(0, 2, 1), out[:, 22]


@pytest.mark.parametrize("hidden", [24, 32])
def test_host_build_of_collect_kernel_matches_pallas_at_width(host, hidden):
    jcfg, tcfg = truncation()
    steps, seed = 20, 11
    k_pop, k_reset = jax.random.split(jax.random.key(0))
    jparams = jax.tree.map(lambda x: jnp.repeat(x, N_COLLECT // 8, axis=0), jsample(k_pop, 8))
    es, _ = jax.vmap(JL2F(jcfg).reset)(jax.random.split(k_reset, N_COLLECT), jparams)
    ps = dynamics_params_from_numpy(to_np(jparams), "cpu").to_soa()
    ss = state_from_numpy(to_np(es.dynamics), "cpu").to_soa()
    p_np, p_t = student(hidden)
    want_obs, want_reset = map(np.asarray, pallas_collect.make_fused_collect(
        p_np, steps, jcfg, chunk=5)(jparams, es.dynamics, seed))
    rc, obs, reset = host_collect(host, ops_eval.flatten_policy(p_t), ps, ss, steps, seed, tcfg)
    assert rc == 0
    obs, reset = obs.numpy(), reset.numpy()
    np.testing.assert_array_equal(reset, want_reset)
    assert want_reset[7].mean() > 0.9 and want_reset[15].mean() > 0.9
    seen = np.cumsum(want_reset, axis=0)  # the rows up to each env's first post-reset row
    keep = np.concatenate([np.zeros((2, N_COLLECT)), seen[:-2]]) == 0
    assert keep[8].all() and not keep[10].any()
    np.testing.assert_allclose(obs[keep], want_obs[keep], atol=2e-4, rtol=0)


def test_host_build_refuses_widths_it_is_not_built_for(host):
    wide = student(20)[1]
    weights = ops_eval.flatten_policy(wide)
    ps, ss = torch.zeros((42, 4)), torch.zeros((17, 4))
    assert host_eval(host, weights, ps, ss, 1)[0] == -1
    assert host_collect(host, weights, ps, ss, 1, 0, EnvConfig())[0] == -1
    with pytest.raises(ValueError, match=r"hidden widths \(8, 16, 24, 32, 48\)"):
        ops_eval.eval_soa(weights, ps, ss, 1)
    with pytest.raises(ValueError, match=r"hidden widths \(8, 16, 24, 32, 48\)"):
        ops_collect.collect_soa(weights, ps, ss, 1, 0)
