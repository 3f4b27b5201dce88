"""The teacher farm (`rl/runner.py`, `distill/population.py`,
`apps/pre_training.py`, `apps/sample_dynamics.py`) against the JAX package, on
the CPU at a tiny size.

Random streams differ between the packages, so parity is on handed-across
initial states under a deterministic exploration policy (the committed
airframes have no disturbance forces): transitions within atol 2e-4 over a
few steps, the tolerance of the distillation collect test. Elsewhere the
counters (`total_env_steps`, `ptr`, `size`) must advance as the JAX package's
do and the metrics must be finite.
"""

import dataclasses
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raptor_tpu.apps import post_training as jpost_cli
from raptor_tpu.apps import pre_training as jpre_cli
from raptor_tpu.distill import population as jpopulation
from raptor_tpu.env import EnvConfig as JEnvConfig
from raptor_tpu.env import L2F as JL2F
from raptor_tpu.env import sample_population as jsample
from raptor_tpu.env.types import InitConfig as JInitConfig
from raptor_tpu.env.types import TerminationConfig as JTerminationConfig
from raptor_tpu.rl import networks as jnetworks
from raptor_tpu.rl import runner as jrunner
from raptor_tpu.rl import sac as jsac
from raptor_tpu.utils.extrack import Run as JRun
from raptor_tpu_torch.apps import evaluate as evaluate_cli
from raptor_tpu_torch.apps import pack_teachers
from raptor_tpu_torch.apps import post_training as post_cli
from raptor_tpu_torch.apps import pre_training as pre_cli
from raptor_tpu_torch.apps import sample_dynamics as sample_cli
from raptor_tpu_torch.checkpoint import (
    dynamics_params_from_numpy, h5, mlp_from_numpy, state_from_numpy,
)
from raptor_tpu_torch.distill import population
from raptor_tpu_torch.env import EnvConfig, InitConfig, L2F, TerminationConfig
from raptor_tpu_torch.env.io import load_params_json
from raptor_tpu_torch.env.quad import EnvState
from raptor_tpu_torch.env.recovery import recovery_action
from raptor_tpu_torch.env.types import tree_map
from raptor_tpu_torch.rl import networks, runner, sac

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACK = "artifacts/teachers_seed900_hovergate.npz"
GENTLE = dict(max_angle=0.2, linear_velocity_std=0.02, angular_velocity_std=0.02)
WIDE = dict(position_bound=50.0, angular_velocity_bound=1000.0)
K, N = 2, 4
SMALL = dict(n_teachers=K, envs_per_teacher=N, rollout_length=3, gradient_steps=2, batch_size=8,
             replay_capacity=8, warmup_super_steps=1, sample_rows=True)


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def test_configs_equal_jax_field_by_field():
    assert fields(runner.RunnerConfig()) == fields(jrunner.RunnerConfig())
    assert fields(population.PopulationConfig()) == fields(jpopulation.PopulationConfig())


def env_state_from_jax(jes, device="cpu") -> EnvState:
    """The JAX package's vmapped EnvState (without its keys) as the port's."""
    return EnvState(
        dynamics=state_from_numpy(to_np(jes.dynamics), device),
        action_history=torch.from_numpy(np.array(jes.action_history)),
        angvel_history=torch.from_numpy(np.array(jes.angvel_history)),
        t=torch.from_numpy(np.array(jes.t)),
    )


@pytest.mark.parametrize("stack", [False, True])
def test_collect_rollout_matches_jax_from_handed_initial_states(stack):
    jenv = JL2F(JEnvConfig(init=JInitConfig(**GENTLE), termination=JTerminationConfig(**WIDE)))
    env = L2F(EnvConfig(init=InitConfig(**GENTLE), termination=TerminationConfig(**WIDE)))
    n_flat = K * N if stack else N
    jparams = jsample(jax.random.key(1), n_flat)
    jes, jobs = jax.vmap(jenv.reset)(jax.random.split(jax.random.key(2), n_flat), jparams)
    init = lambda k: jnetworks.actor_init(k, jenv.OBSERVATION_DIM, 4)  # noqa: E731
    jactor = jax.vmap(init)(jax.random.split(jax.random.key(3), K)) if stack \
        else init(jax.random.key(3))
    # a larger head than the 0.01-scaled init, so the actions matter
    jactor["layers"][-1]["w"] = jactor["layers"][-1]["w"] * 100.0
    jcfg = jrunner.RunnerConfig(n_envs=N, rollout_length=6)
    cfg = runner.RunnerConfig(n_envs=N, rollout_length=6)

    def jcollect(actor, params, es, obs, key):
        explore = lambda k, o: jnetworks.actor_mean(actor, o)  # noqa: E731
        return jrunner.collect_rollout(jenv, params, jcfg, explore, es, obs, key)

    if stack:
        fold = lambda x: x.reshape(K, N, *x.shape[1:])  # noqa: E731
        _, jobs2, _, ref = jax.vmap(jcollect)(
            jactor, jax.tree.map(fold, jparams),
            jax.tree.map(fold, jes), fold(jobs), jax.random.split(jax.random.key(4), K))
    else:
        _, jobs2, _, ref = jcollect(jactor, jparams, jes, jobs, jax.random.key(4))

    flat = dynamics_params_from_numpy(to_np(jparams), "cpu")
    params = tree_map(lambda x: x.reshape(K, N, *x.shape[1:]), flat) if stack else flat
    actor = mlp_from_numpy(to_np(jactor), "cpu")
    obs0 = torch.from_numpy(np.array(jobs))
    obs0 = obs0.reshape(K, N, -1) if stack else obs0
    es2, obs2, got = runner.collect_rollout(
        env, params, cfg, lambda o: networks.actor_mean(actor, o), env_state_from_jax(jes), obs0,
        torch.Generator().manual_seed(0))
    lead = (K,) if stack else ()
    assert got[0].shape == (*lead, 6, N, env.OBSERVATION_DIM) and got[2].shape == (*lead, 6, N)
    for g, r, name in zip(got, ref, ("obs", "action", "reward", "next_obs", "done")):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=2e-4, rtol=0, err_msg=name)
    np.testing.assert_allclose(obs2.numpy(), np.asarray(jobs2), atol=2e-4)
    assert float(got[4].sum()) == 0.0 and int(es2.t.min()) == 6
    # next_obs of step t is obs of step t + 1 while nothing resets
    torch.testing.assert_close(got[3][..., :-1, :, :], got[0][..., 1:, :, :], atol=0, rtol=0)
    assert float(got[1].abs().max()) > 0.05


def test_done_is_termination_only_and_next_obs_is_the_pre_reset_observation():
    """Episode length 2: every env truncates at step 2 and auto-resets, which
    is no termination, and the stored next_obs is not the fresh state's."""
    env = L2F(EnvConfig(episode_length=2, init=InitConfig(**GENTLE),
                        termination=TerminationConfig(**WIDE)))
    gen = torch.Generator().manual_seed(0)
    airframes = population.sample_teacher_airframes(gen, K)
    states, env_params, run_cfg = population.population_init(
        gen, env, airframes, population.PopulationConfig(**SMALL))
    states = runner.collect(states, env, env_params, run_cfg)
    buf = states.buffer
    assert float(buf.done.sum()) == 0.0 and buf.size == 3
    # the env reset after step 2 (row 1): row 2 starts from a fresh state
    assert not torch.allclose(buf.next_obs[:, 1], buf.obs[:, 2], atol=1e-3)
    torch.testing.assert_close(buf.next_obs[:, 0], buf.obs[:, 1], atol=0, rtol=0)
    assert float(buf.obs[:, 2, :, 18:22].abs().max()) == 0.0  # zero previous action


def test_counters_advance_as_jax_population_does():
    """Warm-up, one super-step, one multi-step of 2 and one demonstrator
    collect on both sides: `total_env_steps`, `ptr` and `size` agree, the ring
    wraps, the metrics are finite and per member."""
    jenv, env = JL2F(JEnvConfig()), L2F(EnvConfig())
    jpop, pop = jpopulation.PopulationConfig(**SMALL), population.PopulationConfig(**SMALL)
    jair = jpopulation.sample_teacher_airframes(jax.random.key(0), K)
    jstates, jparams, jrun = jpopulation.population_init(jax.random.key(1), jenv, jair, jpop)
    gen = torch.Generator().manual_seed(0)
    air = dynamics_params_from_numpy(to_np(jair), "cpu")
    states, env_params, run_cfg = population.population_init(gen, env, air, pop)
    assert fields(run_cfg) == fields(jrun)
    assert states.obs.shape == tuple(jstates.obs.shape) == (K, N, 31)
    assert states.buffer.obs.shape == tuple(jstates.buffer.obs.shape) == (K, 8, N, 31)

    def same_counters():
        assert states.total_env_steps == int(jstates.total_env_steps[0])
        assert states.buffer.ptr == int(jstates.buffer.ptr[0])
        assert states.buffer.size == int(jstates.buffer.size[0])

    jstates = jpopulation.make_population_warmup(jenv, jrun)(jstates, jparams)
    states = population.make_population_warmup(env, run_cfg)(states, env_params)
    same_counters()
    # the warm-up's actions are uniform in [-1, 1], not the actor's (near 0 at init)
    warm = states.buffer.action[:, :3]
    assert float(warm.abs().max()) <= 1.0 and float(warm.abs().mean()) > 0.3

    scfg = sac.SACConfig()
    jstates, jm = jpopulation.make_population_super_step(jenv, jrun, jsac.SACConfig())(
        jstates, jparams)
    states, m = population.make_population_super_step(env, run_cfg, scfg)(states, env_params)
    same_counters()
    jstates, jm = jpopulation.make_population_multi_step(jenv, jrun, jsac.SACConfig(), 2)(
        jstates, jparams)
    for unroll in (True,):
        states, m = population.make_population_multi_step(env, run_cfg, scfg, 2, unroll=unroll)(
            states, env_params)
    same_counters()
    assert states.sac.step == int(jstates.sac.step[0]) == 6
    jstates = jpopulation.make_population_demo_collect(jenv, jrun, adaptive=True)(jstates, jparams)
    states = population.make_population_demo_collect(env, run_cfg, adaptive=True)(
        states, env_params)
    same_counters()
    assert states.buffer.size == 8 and states.buffer.ptr == 15 % 8 and states.total_env_steps == 60
    for name in m._fields:
        got, ref = getattr(m, name), np.asarray(getattr(jm, name))
        assert got.shape == ref.shape == (K,) and bool(torch.isfinite(got).all()), name
    assert bool(torch.isfinite(states.obs).all())
    assert bool(torch.isfinite(states.buffer.reward).all())


def test_unroll_changes_nothing():
    env = L2F(EnvConfig())
    outs = []
    for unroll in (True, False):
        gen = torch.Generator().manual_seed(5)
        air = population.sample_teacher_airframes(gen, K)
        states, env_params, run_cfg = population.population_init(
            gen, env, air, population.PopulationConfig(**SMALL))
        states = population.make_population_warmup(env, run_cfg)(states, env_params)
        states, m = population.make_population_multi_step(
            env, run_cfg, sac.SACConfig(), 2, unroll=unroll)(states, env_params)
        outs.append((m.critic_loss, states.sac.actor["layers"][0]["w"].detach()))
    torch.testing.assert_close(outs[0][0], outs[1][0], atol=0, rtol=0)
    torch.testing.assert_close(outs[0][1], outs[1][1], atol=0, rtol=0)


def test_collect_scripted_stores_the_demonstrators_actions():
    env = L2F(EnvConfig(init=InitConfig(angle_power=4.0)))
    gen = torch.Generator().manual_seed(1)
    air = population.sample_teacher_airframes(gen, K)
    states, env_params, run_cfg = population.population_init(
        gen, env, air, population.PopulationConfig(**SMALL))
    flat = population.flatten_envs(env_params)
    first = recovery_action(flat, states.env_state.dynamics, adaptive=True)
    obs0 = states.obs.clone()
    states = runner.collect_scripted(states, env, env_params, run_cfg, adaptive=True)
    torch.testing.assert_close(states.buffer.action[:, 0], first.reshape(K, N, 4), atol=0, rtol=0)
    torch.testing.assert_close(states.buffer.obs[:, 0], obs0, atol=0, rtol=0)
    assert (states.buffer.ptr, states.buffer.size, states.total_env_steps) == (3, 3, 12)


def test_single_learner_runner_without_the_population_axis():
    env = L2F(EnvConfig())
    gen = torch.Generator().manual_seed(2)
    cfg = runner.RunnerConfig(n_envs=N, rollout_length=3, gradient_steps=2, batch_size=8,
                              replay_capacity=8, actor_obs_dim=22)
    params = tree_map(lambda x: x[0], population.broadcast_airframe_to_envs(
        population.sample_teacher_airframes(gen, 1), N))
    state = runner.trainer_init(gen, env, params, cfg)
    assert state.obs.shape == (N, 31) and state.buffer.obs.shape == (8, N, 31)
    assert state.sac.actor["layers"][0]["w"].shape == (22, 64)  # the actor sees obs[:, :22]
    state = runner.make_warmup_step(env, cfg)(state, params)
    state, m = runner.make_super_step(env, cfg, sac.SACConfig())(state, params)
    assert m.critic_loss.shape == () and bool(torch.isfinite(m.critic_loss))
    assert (state.buffer.ptr, state.buffer.size, state.total_env_steps) == (6, 6, 24)
    with pytest.raises(ValueError, match="n_envs"):
        runner.trainer_init(gen, env, params, dataclasses.replace(cfg, n_envs=N + 1))


def test_population_eval_matches_jax_on_a_committed_pack():
    """Three committed teachers, 4 envs each, 60 steps, from the initial
    states the JAX evaluation draws from its keys."""
    k, n, steps = 3, 4, 60
    actors_np, frames_np = pack_teachers.load_teacher_pack(PACK)
    actors_np = {"layers": [{kk: v[:k] for kk, v in layer.items()}
                            for layer in actors_np["layers"]]}
    frames_np = {f: v[:k] for f, v in frames_np.items()}
    jenv, env = JL2F(JEnvConfig()), L2F(EnvConfig())
    from raptor_tpu.env.types import DynamicsParams as JDynamicsParams

    jair = JDynamicsParams(**{f: jnp.asarray(v) for f, v in frames_np.items()})
    jstates = jax.vmap(lambda ky: jsac.sac_init(ky, 31, 4))(jax.random.split(jax.random.key(0), k))
    jstates = jstates.replace(actor=jax.tree.map(jnp.asarray, actors_np))
    keys = jax.random.split(jax.random.key(9), k)
    ref = jpopulation.make_population_eval(jenv, n, steps)(jstates, jair, keys)

    def initial(key, airframe):  # as evaluation.evaluate resets
        p = jax.tree.map(lambda x: jnp.broadcast_to(x, (n,) + x.shape), airframe)
        return jax.vmap(jenv.reset)(jax.random.split(key, n), p)[0].dynamics

    jstate0 = jax.vmap(initial)(keys, jair)  # [k, n, ...]
    state0 = state_from_numpy(
        jax.tree.map(lambda x: np.asarray(x).reshape(k * n, *x.shape[2:]), jstate0), "cpu")
    learner = sac.SACState(actor=mlp_from_numpy(actors_np, "cpu"), critic=None,
                           target_critic=None, log_alpha=None, actor_opt=None, critic_opt=None,
                           alpha_opt=None, step=0)
    got = population.make_population_eval(env, n, steps)(
        learner, dynamics_params_from_numpy(frames_np, "cpu"), torch.Generator(), state=state0)
    for name in got._fields:
        g, r = getattr(got, name).numpy(), np.asarray(getattr(ref, name))
        assert g.shape == r.shape == (k,)
        np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-4, err_msg=name)
    assert float(got.episode_length_mean.min()) > 5  # hover-gated teachers fly
    # and drawn from the generator: one value per member
    drawn = population.make_population_eval(env, n, 10)(
        learner, dynamics_params_from_numpy(frames_np, "cpu"), torch.Generator().manual_seed(0))
    assert drawn.return_mean.shape == (k,) and bool(torch.isfinite(drawn.return_std).all())


def test_train_population_logs_metrics_and_evaluations():
    env = L2F(EnvConfig(episode_length=20))
    logged = []
    learner, air = population.train_population(
        torch.Generator().manual_seed(3), env, population.PopulationConfig(**SMALL),
        sac.SACConfig(stack_critics=True), n_super_steps=2,
        log_fn=lambda i, x: logged.append((i, x)), eval_every=2)
    assert [i for i, _ in logged] == [0, 1, 1]
    assert isinstance(logged[0][1], sac.SACMetrics) and logged[2][1].return_mean.shape == (K,)
    assert air.mass.shape == (K,) and learner.step == 4
    assert learner.actor["layers"][0]["w"].shape == (K, 31, 64)


# ---------------------------------------------------------------------------
# checkpoints, manifests, CLIs
# ---------------------------------------------------------------------------


def random_actor(seed, k=None):
    gen = torch.Generator().manual_seed(seed)
    return networks.actor_init(gen, 31, 4, n_stack=k)


@pytest.mark.parametrize("suffix", [".npz", ".h5"])
def test_save_mlp_actor_round_trips_in_both_forms(tmp_path, suffix):
    actor = random_actor(0)
    path = str(tmp_path / f"teacher{suffix}")
    h5.save_mlp_actor(path, actor, meta={"teacher_index": 7})
    back = h5.load_mlp_actor(path)
    for mine, theirs in zip(actor["layers"], back["layers"]):
        np.testing.assert_array_equal(mine["w"].numpy(), theirs["w"])
        np.testing.assert_array_equal(mine["b"].numpy(), theirs["b"])
    if suffix == ".npz":
        assert h5.is_mlp_actor_npz(path) and not h5.is_mlp_actor_npz(os.path.join(ROOT, PACK))
        with np.load(path) as z:
            assert json.loads(str(z["actor/meta"])) == {"teacher_index": 7}
        # the form is the caller's to choose where the path does not say
        tmp = path + ".tmp"
        h5.save_mlp_actor(tmp, actor, npz=True)
        os.replace(tmp, path)
        assert len(h5.load_mlp_actor(path)["layers"]) == 3
    else:
        # the JAX package reads the port's file and the port reads the JAX package's
        from raptor_tpu.checkpoint import h5 as jh5

        theirs = jh5.load_mlp_actor(path)
        np.testing.assert_array_equal(theirs["layers"][1]["w"], actor["layers"][1]["w"].numpy())
        jpath = str(tmp_path / "jax.h5")
        jh5.save_mlp_actor(jpath, {"layers": [{k: v.numpy() for k, v in layer.items()}
                                               for layer in actor["layers"]]})
        np.testing.assert_array_equal(
            h5.load_mlp_actor(jpath)["layers"][2]["b"], actor["layers"][2]["b"].numpy())


def test_manifests_cross_load_between_the_packages(tmp_path):
    """A manifest written by the JAX package's `export_teachers` loads in the
    port, and one written by the port's loads in the JAX package (`.h5`)."""
    jenv = JL2F(JEnvConfig())
    jair = jpopulation.sample_teacher_airframes(jax.random.key(0), K)
    jstates, _, _ = jpopulation.population_init(
        jax.random.key(1), jenv, jair, jpopulation.PopulationConfig(**SMALL))
    jrun = JRun(base_dir=str(tmp_path / "jax"), name="pre_training")
    jmanifest = jpre_cli.export_teachers(jrun, jstates, jair, K, 123)
    jrun.close()
    actors, frames = post_cli.load_teachers(jmanifest, "cpu")
    for mine, theirs in zip(actors["layers"], to_np(jstates.sac.actor)["layers"]):
        np.testing.assert_array_equal(mine["w"].numpy(), theirs["w"])
    np.testing.assert_allclose(frames.mass.numpy(), np.asarray(jair.mass), rtol=1e-7)

    env, gen = L2F(EnvConfig()), torch.Generator().manual_seed(0)
    air = population.sample_teacher_airframes(gen, K)
    states, _, _ = population.population_init(
        gen, env, air, population.PopulationConfig(**SMALL))
    from raptor_tpu_torch.utils.extrack import Run

    run = Run(base_dir=str(tmp_path / "port"), name="pre_training")
    manifest = pre_cli.export_teachers(run, states, air, K, 123)
    run.close()
    lines = open(manifest).read().split()
    assert len(lines) == K and all(p.endswith(f"_teacher{i}.h5") for i, p in enumerate(lines))
    jactors, jframes = jpost_cli.load_teachers(manifest)
    np.testing.assert_array_equal(
        np.asarray(jactors["layers"][0]["w"]), states.sac.actor["layers"][0]["w"].detach().numpy())
    np.testing.assert_allclose(np.asarray(jframes.inertia_diag), air.inertia_diag.numpy(),
                               rtol=1e-7)
    # every file went through a .tmp and none is left; a second export overwrites in place
    ckpt_dir = os.path.dirname(lines[0])
    names = sorted(os.listdir(ckpt_dir))
    assert len(names) == 2 * K and not any(n.endswith(".tmp") for n in names)
    assert pre_cli.export_teachers(run, states, air, K, 123) == manifest
    assert sorted(os.listdir(ckpt_dir)) == names
    assert not any(n.endswith(".tmp") for n in os.listdir(run.dir))


def test_npz_manifest_and_mixed_manifest_load(tmp_path, monkeypatch):
    """Where h5py is missing the export writes `.npz` actors; a manifest of
    them, alone or mixed with a teacher pack, loads in line order."""
    import importlib.util

    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == "h5py" else real(name, *a))
    env, gen = L2F(EnvConfig()), torch.Generator().manual_seed(4)
    air = population.sample_teacher_airframes(gen, K)
    states, _, _ = population.population_init(gen, env, air, population.PopulationConfig(**SMALL))
    from raptor_tpu_torch.utils.extrack import Run

    run = Run(base_dir=str(tmp_path), name="pre_training")
    manifest = pre_cli.export_teachers(run, states, air, K, 5)
    run.close()
    lines = open(manifest).read().split()
    assert all(p.endswith(".npz") for p in lines)
    assert os.path.isfile(lines[1][: -len(".npz")] + "_dynamics.json")
    actors, frames = post_cli.load_teachers(manifest, "cpu")
    torch.testing.assert_close(actors["layers"][2]["w"], states.sac.actor["layers"][2]["w"].detach(),
                               atol=0, rtol=0)
    torch.testing.assert_close(frames.rotor_positions, air.rotor_positions, rtol=1e-7, atol=0)
    mixed = tmp_path / "mixed.txt"
    mixed.write_text(f"{lines[1]}\n{os.path.join(ROOT, PACK)}\n{lines[0]}\n")
    m_actors, m_frames = post_cli.load_teachers(str(mixed), "cpu")
    n_pack = pack_teachers.pack_info(os.path.join(ROOT, PACK))["n_teachers"]
    assert networks.n_actors(m_actors) == n_pack + 2
    torch.testing.assert_close(m_frames.mass[[0, -1]], air.mass[[1, 0]], rtol=1e-7, atol=0)


def test_pre_training_cli_has_every_jax_flag():
    src = open(os.path.join(ROOT, "raptor_tpu", "apps", "pre_training.py")).read()
    jax_flags = set(re.findall(r'add_argument\(\s*"(--[a-z-]+)"', src))
    port_flags = {s for a in pre_cli._parser()._actions for s in a.option_strings}
    assert len(jax_flags) >= 20 and jax_flags <= port_flags
    assert "--device" in port_flags and "--no-unroll-inner" in port_flags
    defaults = vars(pre_cli._parser().parse_args([]))
    assert defaults["device"] == "cuda" and defaults["replay_capacity"] == 4096
    assert defaults["envs_per_teacher"] == 32 and defaults["checkpoint_every"] == 500


def test_cli_pipeline_on_the_cpu(tmp_path, capsys):
    """sample_dynamics -> pre_training -> post_training -> evaluate, all in
    the port, at a tiny size."""
    dyn = str(tmp_path / "dyn")
    sample_cli.main(["--n", "2", "--out", dyn, "--device", "cpu"])
    one = load_params_json(os.path.join(dyn, "1.json"), "cpu")
    assert one.mass.shape == (1,) and one.rotor_positions.shape == (1, 4, 3)
    manifest, summary = pre_cli.main([
        os.path.join(dyn, "0.json"), os.path.join(dyn, "1.json"), "--envs-per-teacher", "8",
        "--super-steps", "2", "--eval-every", "2", "--log-every", "1", "--checkpoint-every", "1",
        "--demo-seed-steps", "1", "--demo-every", "2", "--demo-adaptive", "--stack-critics",
        "--init-angle-power", "2.0", "--angular-velocity-weight", "0.01", "--action-weight", "0.005",
        "--sample-rows", "--replay-capacity", "256", "--experiments-dir", str(tmp_path / "exp"),
        "--device", "cpu"], return_summary=True)
    assert "teachers: 2  manifest:" in capsys.readouterr().out
    assert summary["teachers"] == 2 and summary["env_steps_per_call_per_teacher"] == 16 * 8
    assert len(summary["seconds_per_call"]) == 2 and len(summary["metrics"]) == 2
    (evaluated,) = summary["evaluations"]
    assert evaluated["step"] == 2 * 16 * 8
    assert all(np.isfinite(v) for row in summary["metrics"] + [evaluated] for v in row.values())
    run_dir = os.path.dirname(manifest)
    config = json.load(open(os.path.join(run_dir, "config.json")))
    assert config["pop_cfg"]["sample_rows"] and config["sac_cfg"]["stack_critics"]
    assert len(config["airframes"]) == 2 and config["device"] == "cpu"
    actors, frames = post_cli.load_teachers(manifest, "cpu")
    assert networks.n_actors(actors) == 2
    np.testing.assert_allclose(frames.mass[1:].numpy(), one.mass.numpy(), rtol=1e-6)
    student = post_cli.main([manifest, "--rounds", "1", "--envs-per-teacher", "2",
                             "--experiments-dir", str(tmp_path / "exp"), "--device", "cpu"])
    assert h5.verify_checkpoint(student) < 1e-5
    stats = evaluate_cli.main([student, "--airframe", "crazyflie", "--episode-length", "30",
                               "--envs-per-airframe", "2", "--device", "cpu"])
    assert np.isfinite(stats["return/mean"]) and stats["episodes"] == 2
    with pytest.raises(SystemExit):
        pre_cli.main(["--device", "cpu"])  # neither JSON files nor --population


def test_pre_training_cli_population_mode_with_multi_step(tmp_path):
    manifest, summary = pre_cli.main([
        "--population", "3", "--envs-per-teacher", "4", "--steps-per-call", "2",
        "--super-steps", "1", "--eval-every", "0", "--log-every", "1", "--replay-capacity", "64",
        "--compute-dtype", "bfloat16", "--flat-optim", "--no-unroll-inner",
        "--experiments-dir", str(tmp_path), "--device", "cpu"], return_summary=True)
    assert summary["env_steps_per_call_per_teacher"] == 2 * 16 * 4
    assert len(open(manifest).read().split()) == 3 and summary["evaluations"] == []
    assert np.isfinite(summary["metrics"][0]["critic_loss/mean"])
