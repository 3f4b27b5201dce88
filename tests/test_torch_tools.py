"""The repo's tools in the port (`raptor_tpu_torch/tools/`), held to the JAX
scripts' functions on the CPU at a small size, from airframes, states and
weights JAX made and handed across:

- `quickstart`: the five lines of `examples/quickstart.py` on 16 airframes
  from gentle starts (no env resets in the 10 steps): the `Raptor` action
  (1e-5, the golden-I/O tolerance), the env's reward (1e-5), rollout kernel
  B1's plain version against the Pallas rollout (mean length equal), a
  finite SAC critic loss (its random stream is the port's), and the C++
  header byte for byte;
- `probe_collect_parity`: B3's plain version against JAX's XLA scan at the
  highest matmul precision, 4 steps on 64 envs, inside the collect parity
  gate (1e-4);
- `hover_tail_probe`: B2's plain version against JAX's
  `per_airframe_eval`, episode length 50: alive and length equal;
- `arrest_phase_probe`: the demonstrator's actions on the handed states
  (1e-5, as `tests/test_torch_distill.py` holds demonstrator labels) and 40
  steps of its tilt and angular rate (1e-4);
- `parity_table`: the markdown byte for byte;
and that no tool writes under `artifacts/` unless `--out` names a file.
"""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from raptor_tpu_torch.checkpoint import (
    dynamics_params_from_numpy, from_numpy, h5, state_from_numpy)
from raptor_tpu_torch.env import EnvConfig, InitConfig, L2F

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPZ = os.path.join(ROOT, "raptor_tpu_torch", "data", "student_rateFlagCurPure.npz")
H5 = os.path.join(ROOT, "artifacts", "student_rateFlagCurPure.h5")


def _np(tree):
    import jax

    return jax.tree.map(np.asarray, tree)


def _frames(jframes):
    return dynamics_params_from_numpy(vars(_np(jframes)), "cpu")


def _state(jstate):
    return state_from_numpy(vars(_np(jstate)), "cpu")


def test_quickstart_five_lines_match_jax():
    import jax
    import jax.numpy as jnp

    from raptor_tpu import Raptor as JRaptor
    from raptor_tpu.checkpoint import code_export as jexport
    from raptor_tpu.env import EnvConfig as JEnvConfig
    from raptor_tpu.env import L2F as JL2F
    from raptor_tpu.env import sample_population as jsample
    from raptor_tpu.env.types import InitConfig as JInitConfig
    from raptor_tpu.ops.pallas_rollout import fused_rollout as jfused_rollout
    from raptor_tpu_torch.tools import quickstart

    n = 16
    jframes = jsample(jax.random.key(0), n)
    gentle = JL2F(JEnvConfig(init=JInitConfig(max_angle=0.2, linear_velocity_std=0.02,
                                             angular_velocity_std=0.02)))
    es, _ = jax.vmap(gentle.reset)(jax.random.split(jax.random.key(1), n), jframes)
    out = quickstart.run(NPZ, "cpu", n, _frames(jframes), _state(es.dynamics), verbose=False)

    jpolicy = JRaptor(H5, batch_size=2)
    jpolicy.reset()
    np.testing.assert_allclose(out["raptor_action"],
                               jpolicy.evaluate_step(np.zeros((2, 22), np.float32)), atol=1e-5)
    _, v_step = JL2F(JEnvConfig()).vector_ops()
    step = jax.jit(v_step)
    for _ in range(10):
        es, obs, reward, done, _ = step(jframes, es, jnp.zeros((n, 4)))
    assert out["env_done"] == 0 and not bool(done.any())
    assert out["env_obs_shape"] == list(obs.shape)
    assert abs(out["env_reward_mean"] - float(reward.mean())) < 1e-5
    _, _, length = jfused_rollout(jframes, es.dynamics, jnp.zeros((n, 4)), n_steps=20)
    assert out["rollout_mean_length"] == float(length.mean())
    assert np.isfinite(out["sac_critic_loss"])
    jheader = jexport.export_header(jpolicy.params)
    assert out["header"] == jheader
    assert out["header_lines"] == len(jheader.splitlines(keepends=True)) > 20


def test_collect_probe_b3_plain_against_jax_highest_precision():
    import jax
    import jax.numpy as jnp

    from raptor_tpu.env import EnvConfig as JEnvConfig
    from raptor_tpu.env import L2F as JL2F
    from raptor_tpu.env.types import InitConfig as JInitConfig
    from raptor_tpu.env.types import TerminationConfig as JTerminationConfig
    from raptor_tpu.policy import network as jnet
    from raptor_tpu_torch.tools import probe_collect_parity as probe

    n, t = 64, 4
    jcfg = JEnvConfig(
        init=JInitConfig(max_angle=0.2, linear_velocity_std=0.02, angular_velocity_std=0.02),
        termination=JTerminationConfig(position_bound=50.0, angular_velocity_bound=1000.0))
    jenv = JL2F(jcfg)
    student = jnet.init_params(jax.random.key(7))
    params = jax.vmap(jenv.sample_params)(jax.random.split(jax.random.key(5), n))
    es, obs0 = jax.vmap(jenv.reset)(jax.random.split(jax.random.key(9), n), params)
    _, v_step = jenv.vector_ops()

    def body(carry, _):
        es, obs, h = carry
        h2, a = jnet.apply_step(student, h, obs[..., :22])
        es2, obs2, _, _, _ = v_step(params, es, jnp.clip(a, -1, 1))
        return (es2, obs2, h2), obs[..., :22]

    with jax.default_matmul_precision("highest"):
        _, want = jax.lax.scan(body, (es, obs0, jnet.initial_hidden(student, n)), None, length=t)
    obs_f, reset_f, obs_x = probe.collect_and_reference(
        from_numpy(_np(student), "cpu"), _frames(params), _state(es.dynamics), t,
        probe.probe_config(), "cpu")
    rep = probe.report(obs_f, reset_f, torch.from_numpy(np.array(want)), "cpu")
    with open(os.path.join(ROOT, "artifacts", "collect_parity_probe.json")) as f:
        committed = json.load(f)
    assert set(rep) == set(committed) - {"xla_default_vs_highest_precision"}
    assert set(rep["steps"]) == set(committed["steps"])
    assert all(set(row) == set(committed["steps"]["t0"]) for row in rep["steps"].values())
    assert rep["resets_first_steps"] == 0.0
    assert max(row["max"] for row in rep["steps"].values()) < 1e-4  # the collect parity gate
    # the eager reference is the JAX loop too
    np.testing.assert_allclose(obs_x.numpy(), np.asarray(want), atol=1e-4, rtol=0)


def test_hover_tail_b2_plain_matches_jax_per_airframe_eval():
    import jax

    from raptor_tpu.checkpoint import h5 as jh5
    from raptor_tpu.env import EnvConfig as JEnvConfig
    from raptor_tpu.env import L2F as JL2F
    from raptor_tpu.env import sample_population as jsample
    from raptor_tpu.env.types import InitConfig as JInitConfig
    from raptor_tpu_torch.tools import hover_tail_probe as probe

    spec = importlib.util.spec_from_file_location(
        "jax_hover_tail_probe", os.path.join(ROOT, "tools", "hover_tail_probe.py"))
    jprobe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jprobe)

    n_air, per, length, angle = 6, 4, 50, 3.0  # tumbling starts: some envs terminate
    jenv = JL2F(JEnvConfig(init=JInitConfig(max_angle=angle), episode_length=length))
    frames = jsample(jax.random.key(3), n_air)
    stacked = jax.tree.map(lambda x: jax.numpy.repeat(x, per, axis=0), frames)
    key = jax.random.key(4)
    policy = jh5.load_actor(H5)
    alive, steps = jprobe.per_airframe_eval(jenv, stacked, policy, key, n_air, per)
    # the initial states per_airframe_eval drew from its key
    es, _ = jax.vmap(jenv.reset)(jax.random.split(key, n_air * per), stacked)
    config = EnvConfig(init=InitConfig(max_angle=angle), episode_length=length)
    got_alive, got_steps = probe.per_airframe_eval(
        from_numpy(h5.load_actor(NPZ), "cpu"), _frames(stacked), _state(es.dynamics), n_air, per,
        config, "cpu")
    assert 0 < float(np.asarray(alive).mean()) < 1  # some envs terminate inside 50 steps
    np.testing.assert_array_equal(got_alive.numpy(), np.asarray(alive))
    np.testing.assert_array_equal(got_steps.numpy(), np.asarray(steps))
    noisy = _frames(stacked)
    noisy.disturbance_force_std += 0.01
    with pytest.raises(ValueError, match="nonzero disturbance std"):
        probe.per_airframe_eval(from_numpy(h5.load_actor(NPZ), "cpu"), noisy,
                                _state(es.dynamics), n_air, per, config, "cpu")


def test_arrest_probe_matches_jax_from_handed_states():
    import jax
    import jax.numpy as jnp

    from raptor_tpu.env import EnvConfig as JEnvConfig
    from raptor_tpu.env import L2F as JL2F
    from raptor_tpu.env import sample_population as jsample
    from raptor_tpu.env.recovery import recovery_action as jrecovery
    from raptor_tpu.env.recovery import tilt_angle as jtilt
    from raptor_tpu.env.types import InitConfig as JInitConfig
    from raptor_tpu_torch.tools import arrest_phase_probe as probe

    n, steps = 16, 40
    jenv = JL2F(JEnvConfig(init=JInitConfig(max_angle=3.14159265)))
    params = jax.tree.map(lambda x: jnp.repeat(x, 4, axis=0), jsample(jax.random.key(7), 4))
    es, _ = jax.vmap(jenv.reset)(jax.random.split(jax.random.key(0), n), params)
    st, tilts, rates, first = es.dynamics, [], [], None
    dstep = jax.jit(jax.vmap(lambda p, s, a: jenv.dynamics_step(p, s, a, jax.random.key(0))[0]))
    recover = jax.jit(jax.vmap(jrecovery))
    for _ in range(steps):
        act = recover(params, st)
        first = act if first is None else first
        st = dstep(params, st, act)
        tilts.append(np.asarray(jax.vmap(jtilt)(st.orientation)))
        rates.append(np.asarray(jnp.linalg.norm(st.angular_velocity, axis=-1)))
    tilt, w, got_first = probe.trajectory(_frames(params), _state(es.dynamics), steps,
                                          L2F(EnvConfig()))
    np.testing.assert_allclose(got_first.numpy(), np.asarray(first), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tilt.numpy(), np.stack(tilts), atol=1e-4, rtol=0)
    np.testing.assert_allclose(w.numpy(), np.stack(rates), atol=1e-4, rtol=0)
    assert float(np.stack(tilts)[0].max()) > 1.2  # tumbling starts, as the probe flies
    rep = probe.report(tilt, w)
    with open(os.path.join(ROOT, "artifacts", "arrest_phase_probe.json")) as f:
        assert set(rep) == set(json.load(f))
    assert abs(rep["share_severe_tilt_gt_1.2"] + rep["share_arrest_tilt_lt_1.2_w_gt_5"]
               + rep["share_calm"] - 1.0) < 1e-6


def test_parity_table_markdown_equals_jax():
    from raptor_tpu_torch.tools import parity_table

    spec = importlib.util.spec_from_file_location(
        "jax_parity_table", os.path.join(ROOT, "tools", "parity_table.py"))
    jtable = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jtable)
    pattern = os.path.join(ROOT, "artifacts", "eval_parity_*.json")
    want = jtable.render(jtable.load_rows(pattern))
    assert parity_table.render(parity_table.load_rows(pattern)) == want
    assert want.count("\n") > 5


def _artifacts():
    base = os.path.join(ROOT, "artifacts")
    return {name: os.stat(os.path.join(base, name)).st_mtime_ns for name in os.listdir(base)}


def test_no_tool_writes_under_artifacts_without_out(tmp_path, monkeypatch, capsys):
    from raptor_tpu_torch.tools import (
        arrest_phase_probe, hover_tail_probe, parity_table, probe_collect_parity, quickstart)

    monkeypatch.chdir(ROOT)  # where the JAX scripts write their reports
    before = _artifacts()
    quickstart.main(["--checkpoint", NPZ, "--device", "cpu", "--n", "8"])
    probe_collect_parity.main(["--device", "cpu", "--n", "32", "--steps", "2"])
    hover_tail_probe.main([NPZ, "--device", "cpu", "--n-airframes", "2", "--envs-per", "2",
                           "--episode-length", "10"])
    arrest_phase_probe.main(["--device", "cpu"])
    parity_table.main([])
    assert _artifacts() == before
    out = tmp_path / "report.json"
    arrest_phase_probe.main(["--device", "cpu", "--out", str(out)])
    assert json.loads(out.read_text())["envs"] == 64
    assert _artifacts() == before


def test_kernel_ab_rule_and_register_keys():
    """`apps.kernel_ab`, which times B2 and B3 of two checkouts on the card:
    its rule (the change's median inside the parent's [min, max] or at most
    1 % over the parent's median, and no instantiation with more registers
    or spills) and the ptxas keys it shares with `apps.team_sweep`, which
    drop the anonymous namespace's hash that differs between checkouts."""
    from raptor_tpu_torch.apps import kernel_ab, team_sweep

    def side(*runs):
        return kernel_ab.summary([{"ms": dict.fromkeys(kernel_ab.SHAPES, r)} for r in runs])

    regs = {"eval_kernel<16>": [164, 0], "collect_kernel<32>": [168, 68]}
    parent = side(2.90, 2.80, 3.00, 2.85, 2.95)
    assert kernel_ab.verdict(parent, side(2.99, 2.98, 3.0, 2.97, 2.99), regs, regs)["lands"]
    narrow = side(2.90, 2.90, 2.90)
    assert kernel_ab.verdict(narrow, side(2.92, 2.92, 2.92), regs, regs)["lands"]  # under +1 %
    assert not kernel_ab.verdict(narrow, side(2.94, 2.94, 2.94), regs, regs)["lands"]
    assert not kernel_ab.verdict(parent, side(3.05, 3.04, 3.06), regs, regs)["lands"]
    worse = dict(regs, **{"collect_kernel<32>": [170, 68]})
    out = kernel_ab.verdict(parent, parent, regs, worse)
    assert out["registers_or_spills_worse"] == ["collect_kernel<32>"] and not out["lands"]
    assert not kernel_ab.verdict(parent, parent, regs, {"eval_kernel<16>": [164, 0]})["lands"]
    log = ("ptxas info    : Compiling entry function '_ZN39_GLOBAL__N__4701125e_7_eval_cu_2644495c"
           "11eval_kernelILi8EEEvPKf' for 'sm_90a'\n"
           "ptxas info    : Used 128 registers, used 0 barriers\n"
           "    0 bytes stack frame, 4 bytes spill stores, 8 bytes spill loads\n"
           "ptxas info    : Compiling entry function '_Z15fma_peak_kernelILi32EEvPKfPf' for 'sm_90a'\n"
           "ptxas info    : Used 32 registers\n"
           "ptxas info    : Compiling entry function '_ZN39_GLOBAL__N__1a2b3c4d_10_rollout_cu_"
           "5e6f7a8b14rollout_kernelEPKfS1_S1_PfS2_iifffff' for 'sm_90a'\n"
           "ptxas info    : Used 123 registers, used 0 barriers\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n")
    assert team_sweep.ptxas_counts(log) == {"eval_kernel<8>": [128, 12],
                                            "rollout_kernel": [123, 0]}
