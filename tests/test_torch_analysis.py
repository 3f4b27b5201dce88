"""The port's analysis apps against the JAX package, on the CPU.

- `recoverability`: the bound on JAX-sampled airframes and states equals
  JAX's 0/1 output wherever the arrest height lies more than 1e-6 from the
  box floor; `measure` is about 0 at every angle;
- `failure_modes`: `summarize` equals JAX's dict exactly; `probe` from
  handed-across airframes and states gives JAX's termination step and cause
  flags over a short horizon (a pi start tumbles, and two correct f32 codes
  diverge over a long one);
- `scripted_recovery`: the same for the scripted `rollout`; the controller
  beats a passive policy at pi;
- `compare_baseline` and `plot_curves` on two committed distillation logs,
  one standing in for the reference log;
- `profile_pretraining`: a tiny variant runs, its FLOP count equals a count
  by hand, a failing variant makes the CLI exit non-zero.
"""

import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raptor_tpu.apps import compare_baseline as j_compare
from raptor_tpu.apps import failure_modes as j_failure_modes
from raptor_tpu.apps import plot_curves as j_plot_curves
from raptor_tpu.apps import recoverability as j_recoverability
from raptor_tpu.apps import scripted_recovery as j_scripted
from raptor_tpu.checkpoint import h5 as j_h5
from raptor_tpu.env import EnvConfig as JEnvConfig
from raptor_tpu.env import L2F as JL2F
from raptor_tpu.env import presets as jpresets
from raptor_tpu.env import sample_population as jsample
from raptor_tpu.env.types import InitConfig as JInitConfig
from raptor_tpu_torch.apps import compare_baseline, failure_modes, plot_curves
from raptor_tpu_torch.apps import profile_pretraining, recoverability, scripted_recovery
from raptor_tpu_torch.apps.roofline import FLOPS_ENV_STEP
from raptor_tpu_torch.checkpoint import dynamics_params_from_numpy, from_numpy, h5
from raptor_tpu_torch.checkpoint import state_from_numpy
from raptor_tpu_torch.env import EnvConfig, InitConfig, L2F, presets
from raptor_tpu_torch.env.types import State, tree_map

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H5 = os.path.join(ROOT, "artifacts", "student_rateFlagCurPure.h5")
NPZ = os.path.join(ROOT, "raptor_tpu_torch", "data", "student_rateFlagCurPure.npz")
OURS = os.path.join(ROOT, "artifacts", "distill_rateFlagCurPure.tfevents")
STAND_IN = os.path.join(ROOT, "artifacts", "distill_rateFlagCurMixS1.tfevents")
PI = 3.14159265


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------- recoverability


def test_bound_matches_jax_away_from_the_threshold():
    """4,096 JAX airframes and pi starts, half of them pushed down fast near
    the floor so that both outcomes occur: equal 0/1 wherever the arrest
    height is more than 1e-6 from -position_bound."""
    n = 4096
    jenv = JL2F(JEnvConfig(init=JInitConfig(max_angle=PI)))
    keys = jax.random.split(jax.random.key(3), n)
    jparams = jax.vmap(jenv.sample_params)(keys)
    jstate = jax.vmap(jenv.sample_state)(jax.random.split(jax.random.key(4), n), jparams)
    rng = np.random.default_rng(0)
    push = rng.random(n) < 0.5
    pos = np.asarray(jstate.position).copy()
    vel = np.asarray(jstate.linear_velocity).copy()
    pos[push, 2] = rng.uniform(-0.6, 0.0, push.sum())
    vel[push, 2] = -rng.uniform(0.0, 6.0, push.sum())
    jstate = jstate.replace(position=jnp.asarray(pos), linear_velocity=jnp.asarray(vel))
    want = np.asarray(jax.vmap(lambda p, s: j_recoverability.unrecoverable_lower_bound(
        jenv, p, s))(jparams, jstate))

    env = L2F(EnvConfig(init=InitConfig(max_angle=PI)))
    params = dynamics_params_from_numpy(to_np(jparams), "cpu")
    state = state_from_numpy(to_np(jstate), "cpu")
    got = recoverability.unrecoverable_lower_bound(env, params, state).numpy()
    margin = np.abs(recoverability.arrest_height(env, params, state).numpy()
                    + env.config.termination.position_bound)
    away = margin > 1e-6
    assert away.mean() > 0.99
    assert 0.1 < want.mean() < 0.9  # both outcomes are tested
    np.testing.assert_array_equal(got[away], want[away])


def test_measure_is_about_zero_at_every_angle():
    r = recoverability.measure(n=512, seed=1, device="cpu")
    assert r["angles"] == list(recoverability.ANGLES)
    gentle, *_, full = r["unrecoverable_lb"]
    assert gentle <= 0.01 and full <= 0.05
    assert all(0.0 <= v <= 0.05 for v in r["unrecoverable_lb"])


def test_inverted_falling_at_floor_is_doomed_upright_is_not():
    env = L2F(EnvConfig())
    p = presets.crazyflie("cpu")

    def mk(q, z, vz):
        return State(position=torch.tensor([[0.0, 0.0, z]]), orientation=torch.tensor([q]),
                     linear_velocity=torch.tensor([[0.0, 0.0, vz]]),
                     angular_velocity=torch.zeros(1, 3), rpm=torch.full((1, 4), 0.5))

    assert float(recoverability.unrecoverable_lower_bound(
        env, p, mk([0.0, 1.0, 0.0, 0.0], -0.55, -2.0))) == 1.0
    assert float(recoverability.unrecoverable_lower_bound(
        env, p, mk([1.0, 0.0, 0.0, 0.0], -0.3, -0.2))) == 0.0


def test_recoverability_cli_reports_a_bad_annotation_and_keeps_the_bound(tmp_path, capsys):
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    out = tmp_path / "r.json"
    report = recoverability.main(["--n", "64", "--eval-parity", str(bad), "--out", str(out),
                                  "--device", "cpu"])
    assert "measured_eval_parity_error" in report
    assert len(report["unrecoverable_lb"]) == 6
    assert json.loads(out.read_text()) == report


# ---------------------------------------------------------------- failure modes


def random_snap(rng, n):
    t = np.where(rng.random(n) < 0.7, rng.integers(0, 500, n), -1).astype(np.int32)
    return (np.where(t < 0, 1.0, 0.0).astype(np.float32), dict(
        t=t, pos_hit=rng.random(n) < 0.6, w_hit=rng.random(n) < 0.4,
        nonfinite=rng.random(n) < 0.05, z_exit=rng.random(n) < 0.5,
        z_sign=np.sign(rng.standard_normal(n)).astype(np.float32),
        angle_at_term=rng.uniform(0, np.pi, n).astype(np.float32),
        w_norm=rng.uniform(0, 40, n).astype(np.float32)))


@pytest.mark.parametrize("case", ["random", "none_terminated"])
def test_summarize_equals_jax(case):
    alive, snap = random_snap(np.random.default_rng(5), 256)
    if case == "none_terminated":
        alive, snap["t"] = np.ones_like(alive), np.full_like(snap["t"], -1)
    assert failure_modes.summarize(alive, snap) == j_failure_modes.summarize(alive, snap)


def handed_probe_inputs(key, n_airframes, envs_per, airframe, angle):
    """The airframes and initial states JAX's probe and rollout draw from
    `key`, as the port's tensors (and the JAX params)."""
    jenv = JL2F(JEnvConfig(init=JInitConfig(max_angle=angle)))
    m = n_airframes * envs_per
    if airframe == "random":
        frames = jsample(jax.random.fold_in(key, 7), n_airframes)
        jparams = jax.tree.map(lambda x: jnp.repeat(x, envs_per, axis=0), frames)
    else:
        one = getattr(jpresets, airframe)()
        jparams = jax.tree.map(lambda x: jnp.broadcast_to(x, (m,) + x.shape), one)
    es, _ = jenv.vector_ops()[0](jax.random.split(key, m), jparams)
    return (jenv, jparams, dynamics_params_from_numpy(to_np(jparams), "cpu"),
            state_from_numpy(to_np(es.dynamics), "cpu"))


def assert_same_terminations(got_alive, got_snap, want_alive, want_snap, horizon, keys):
    """Envs JAX ended before `horizon` end at the same step with the same
    flags in the port; the rest are alive in the port."""
    t_want = np.asarray(want_snap["t"])
    early = (t_want >= 0) & (t_want < horizon)
    t_got = got_snap["t"].numpy()
    np.testing.assert_array_equal(t_got, np.where(early, t_want, -1))
    np.testing.assert_array_equal(got_alive.numpy(), np.where(early, 0.0, 1.0))
    for k in keys:
        np.testing.assert_array_equal(got_snap[k].numpy()[early], np.asarray(want_snap[k])[early],
                                      err_msg=k)
    return early


@pytest.mark.parametrize("airframe", ["random", "crazyflie"])
def test_probe_matches_jax_from_handed_states_on_a_short_horizon(airframe):
    """8 airframes x 8 envs at pi starts with the committed student: JAX's
    probe over its episode, the port's over the first 100 steps."""
    key, horizon = jax.random.key(11), 100
    want_alive, want_snap = jax.jit(lambda k: j_failure_modes.probe(
        j_h5.load_actor(H5), PI, k, 8, 8, airframe))(key)
    _, _, params, state = handed_probe_inputs(key, 8, 8, airframe, PI)
    policy = from_numpy(h5.load_actor(NPZ), "cpu")
    got_alive, got_snap = failure_modes.probe(
        policy, PI, torch.Generator().manual_seed(0), 8, 8, params=params, state=state,
        steps=horizon)
    early = assert_same_terminations(got_alive, got_snap, want_alive, want_snap, horizon,
                                     ("pos_hit", "w_hit", "nonfinite", "z_exit", "z_sign"))
    for k in ("angle_at_term", "w_norm"):
        np.testing.assert_allclose(got_snap[k].numpy()[early],
                                   np.asarray(want_snap[k])[early], atol=1e-3, err_msg=k)
    if airframe == "random":
        assert early.any()  # the horizon holds terminations to compare


def test_failure_modes_cli_runs_on_the_cpu(tmp_path):
    out = tmp_path / "fm.json"
    report = failure_modes.main(["--checkpoint", NPZ, "--n-airframes", "2", "--envs-per", "2",
                                 "--device", "cpu", "--out", str(out)])
    assert set(report) == {"checkpoint", "angle", "aggregate", "crazyflie"}
    assert report["aggregate"]["episodes"] == 4
    assert json.loads(out.read_text()) == report


# ------------------------------------------------------------- scripted recovery


@pytest.mark.parametrize("airframe,gains", [
    ("random", {}), ("crazyflie", {}),
    ("random", dict(adaptive=True, c_flip=1.0, c_lag=0.8, c_bw=1.5))])
def test_scripted_rollout_matches_jax_from_handed_states(airframe, gains):
    key, horizon = jax.random.key(2), 100
    jenv, jparams, params, state = handed_probe_inputs(key, 8, 4, airframe, PI)
    want_alive, want_snap = jax.jit(lambda k: j_scripted.rollout(
        jenv, jparams, k, 32, w_cap=10.0, k_w=30.0, **gains))(key)
    env = L2F(EnvConfig(init=InitConfig(max_angle=PI)))
    got_alive, got_snap = scripted_recovery.rollout(
        env, params, torch.Generator().manual_seed(0), 32, state=state, steps=horizon,
        w_cap=10.0, k_w=30.0, **gains)
    assert_same_terminations(got_alive, got_snap, want_alive, want_snap, horizon,
                             ("pos_hit", "w_hit"))


def test_scripted_beats_passive_at_pi():
    env = L2F(EnvConfig(init=InitConfig(max_angle=PI)))
    m = 8
    params = tree_map(lambda x: x.expand(m, *x.shape[1:]), presets.crazyflie("cpu"))
    _, snap = scripted_recovery.rollout(env, params, torch.Generator().manual_seed(1), m)
    t = snap["t"].numpy().astype(float)
    assert np.where(t < 0, env.EPISODE_LENGTH, t).mean() > 200


def test_scripted_cli_grid_and_fixed_runs(tmp_path):
    small = ["--n-airframes", "2", "--envs-per", "2", "--device", "cpu"]
    fixed = scripted_recovery.main(small)
    assert [r["airframes"] for r in fixed["runs"]] == ["aggregate", "crazyflie"]
    assert "aggregate" in fixed and fixed["adaptive"] is False
    grid = scripted_recovery.main(small + ["--grid", "1:0.8:1.5;1:0.6:1.0"])
    assert len(grid["runs"]) == 4 and grid["adaptive"] is True and "aggregate" not in grid


# ---------------------------------------------------------- compare_baseline, plots


@pytest.fixture
def stand_in_reference(monkeypatch):
    """A committed distillation log in the place of the shipped reference log,
    for both packages."""
    monkeypatch.setattr(compare_baseline, "reference_log_path", lambda: STAND_IN)
    monkeypatch.setattr(j_compare, "reference_log_path", lambda: STAND_IN)


def test_compare_baseline_equals_jax(stand_in_reference, tmp_path, capsys):
    got = compare_baseline.main([OURS, "--out", str(tmp_path / "port.md")])
    want = j_compare.main([OURS, "--out", str(tmp_path / "jax.md")])
    assert json.loads(json.dumps(got)) == json.loads(json.dumps(want))
    assert got["matched_curves"]["evaluation/return/mean"]
    port_md = (tmp_path / "port.md").read_text().splitlines()
    jax_md = (tmp_path / "jax.md").read_text().splitlines()
    # the one line that names where the reference tarball lies
    differ = [i for i, (a, b) in enumerate(zip(port_md, jax_md)) if a != b]
    assert len(port_md) == len(jax_md) and differ == [3]
    assert "$RAPTOR_REFERENCE_DIR/data/raptor-policy-checkpoint.tar.gz" in port_md[3]


def test_summarize_and_matched_curves_equal_jax_on_a_shorter_reference():
    """Our 75.5M-step run against a 10.2M-step log: the matched curve stops at
    the reference's last step."""
    from raptor_tpu_torch.utils.tfevents import read_scalars

    ours = read_scalars(OURS)
    ref = read_scalars(os.path.join(ROOT, "artifacts", "distill_32teachers.tfevents"))
    assert compare_baseline.matched_curves(ours, ref) == j_compare.matched_curves(ours, ref)
    assert compare_baseline.summarize(ref, "r") == j_compare.summarize(ref, "r")


def test_reference_log_path_raises_without_the_reference(monkeypatch):
    monkeypatch.delenv("RAPTOR_REFERENCE_DIR", raising=False)
    with pytest.raises(FileNotFoundError):
        compare_baseline.reference_log_path()


def test_plot_curves_writes_a_png(stand_in_reference, tmp_path, capsys):
    pytest.importorskip("matplotlib")
    out = tmp_path / "curves.png"
    plot_curves.main([OURS, "--label", "ours", "--out", str(out)])
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    ref = tmp_path / "jax.png"
    j_plot_curves.main([OURS, "--label", "ours", "--out", str(ref)])
    assert ref.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


# ------------------------------------------------------------ profile_pretraining

TINY = dict(envs_per_teacher=4, rollout_length=4, gradient_steps=2, batch_size=16,
            replay_capacity=32, steps_per_call=1, n_lo=1, n_hi=2)


@pytest.mark.parametrize("mode", ["full", "collect", "train"])
def test_tiny_variant_runs_on_the_cpu(mode):
    row = profile_pretraining.profile_variant("tiny", n_teachers=2, mode=mode, device="cpu",
                                              **TINY)
    assert row["mode"] == mode and row["teachers"] == 2
    assert math.isfinite(row["s_per_super_step"]) and row["env_steps_per_s"] > 0


def test_flop_count_equals_a_count_by_hand():
    """Matmul FLOPs of one SAC update, counted layer by layer: 2 B in out a
    product, forward and backward; the backward computes a weight gradient
    for every layer of the network being stepped and an input gradient for
    every layer whose input needs one."""
    b, e, a = 16, 4, 4
    d = L2F(EnvConfig()).OBSERVATION_DIM
    actor = [d * 64, 64 * 64, 64 * 2 * a]
    q = [(d + a) * 64, 64 * 64, 64 * 1]
    f, big_a, big_q = 2 * b, sum(actor), sum(q)
    critic_step = (f * big_a  # next action (no gradient)
                   + 2 * f * big_q  # twin target critics (no gradient)
                   + 2 * f * big_q  # twin critics
                   + 2 * (f * big_q + f * (big_q - q[0])))  # their weight and input gradients
    actor_step = (f * big_a + 2 * f * big_q  # actor, critics on its action
                  + 2 * f * big_q  # input gradients through the critics
                  + f * big_a + f * (big_a - actor[0]))  # the actor's weight and input gradients
    got = profile_pretraining.count_flops(envs_per_teacher=e, rollout_length=4,
                                          gradient_steps=2, batch_size=b)
    assert got["grad_step_flops"] == critic_step + actor_step
    assert got["collect_step_flops"] == 2 * e * big_a + e * FLOPS_ENV_STEP
    assert got["flops_per_super_step_per_teacher"] == (
        2 * got["grad_step_flops"] + 4 * got["collect_step_flops"])
    assert "FlopCounterMode" in got["method"] and "left out" in got["method"]


def test_flops_only_places_timed_rows_against_a_roofline_file(tmp_path, capsys):
    out, roof = tmp_path / "p.json", tmp_path / "roofline.json"
    out.write_text(json.dumps({"rows": [
        {"variant": "a", "mode": "full", "teachers": 128, "s_per_super_step": 0.5},
        {"variant": "b", "mode": "collect", "teachers": 128, "s_per_super_step": 0.1}]}))
    roof.write_text(json.dumps({"vpu_peak": {"fma_peak_flops_per_s": 5e13, "card": "a card"}}))
    report = profile_pretraining.main(["--flops-only", "--out", str(out), "--roofline",
                                       str(roof), "--device", "cpu"])
    total = report["flops"]["flops_per_super_step_per_teacher"] * 128
    full, collect = report["rows"]
    assert full["vpu_f32_roofline_fraction"] == pytest.approx(total / 0.5 / 5e13, rel=1e-12)
    assert "vpu_f32_roofline_fraction" not in collect
    assert report["peak"] == {"fma_peak_flops_per_s": 5e13, "card": "a card"}
    roof.write_text(json.dumps({"vpu_peak": {"fma_peak_flops_per_s": 5e13, "card": None}}))
    with pytest.raises(ValueError):
        profile_pretraining.main(["--flops-only", "--out", str(out), "--roofline", str(roof),
                                  "--device", "cpu"])
    with pytest.raises(ValueError):  # no card to measure the peak on
        profile_pretraining.main(["--flops-only", "--out", str(out), "--device", "cpu"])


def test_a_failing_variant_is_an_error_row_and_a_non_zero_exit(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(profile_pretraining, "VARIANTS", [
        ("tiny_full", dict(n_teachers=2, **TINY)),
        ("tiny_bogus", dict(n_teachers=2, mode="bogus", **TINY))])
    out = tmp_path / "p.json"
    with pytest.raises(SystemExit) as exc:
        profile_pretraining.main(["--out", str(out), "--device", "cpu"])
    assert exc.value.code == 1
    rows = json.loads(out.read_text())["rows"]
    assert "s_per_super_step" in rows[0] and rows[1]["error"].startswith("ValueError")
