"""TD3, PPO, the generic runner, the training loop and its tools
(`raptor_tpu_torch/rl/{td3,ppo,runner_generic,loop}.py`,
`utils/{guards,state_checkpoint,profiling}.py`) against the JAX package, on
the CPU.

States, batches, noise and permutations are made with numpy or JAX and handed
across as numpy arrays; the JAX side runs as its own tests run it.
Tolerances: `td3_update` and `ppo_update` 1e-5 on every leaf and rtol 1e-4 on
the metrics (the bars of tests/test_torch_sac.py); GAE 1e-6 against the JAX
scan and the manual formula (tests/test_td3_ppo_loop.py:82); `ppo_rollout`
2e-4 over the rollout (the collect tolerance of
tests/test_torch_pretraining.py); resume from a state checkpoint and a guard's
rollback exact.
"""

import json
import os

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
from raptor_tpu.rl import networks as jnetworks
from raptor_tpu.rl import ppo as jppo
from raptor_tpu.rl import td3 as jtd3
from raptor_tpu_torch.checkpoint import (
    critic_from_numpy, dynamics_params_from_numpy, mlp_from_numpy, ppo_state_from_numpy,
    state_from_numpy, td3_state_from_numpy,
)
from raptor_tpu_torch.env import EnvConfig, InitConfig, L2F, TerminationConfig, sample_population
from raptor_tpu_torch.env.quad import EnvState
from raptor_tpu_torch.rl import loop, networks, ppo, runner, runner_generic, sac, td3
from raptor_tpu_torch.utils import guards, profiling
from raptor_tpu_torch.utils import state_checkpoint as sck
from raptor_tpu_torch.utils.extrack import Run

GENTLE = dict(max_angle=0.2, linear_velocity_std=0.02, angular_velocity_std=0.02)
WIDE = dict(position_bound=50.0, angular_velocity_bound=1000.0)
OBS, ACT, B = 9, 4, 32
SMALL = dict(actor_hidden=(16, 16), critic_hidden=(16, 16))


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def t(x):
    return torch.from_numpy(np.array(x, np.float32))


def assert_trees_close(mine, ref_np, convert, atol=1e-5, what=""):
    for a, b in zip(networks.tree_leaves(mine), networks.tree_leaves(convert(ref_np, "cpu"))):
        np.testing.assert_allclose(a.detach().numpy(), b.numpy(), atol=atol, rtol=0, err_msg=what)


def test_configs_equal_jax():
    import dataclasses

    for mine, ref in ((td3.TD3Config(), jtd3.TD3Config()), (ppo.PPOConfig(), jppo.PPOConfig())):
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)


# ---------------------------------------------------------------------------
# TD3
# ---------------------------------------------------------------------------


def test_four_td3_updates_match_jax_and_delay_the_policy():
    """Four steps from a handed-across state with JAX's target noise: every
    leaf and the metrics agree. On the odd (delayed) steps the actor, its Adam
    moments and count, the target actor and the target critic stay as they
    were; the actor loss is reported on every step."""
    jcfg, cfg = jtd3.TD3Config(**SMALL), td3.TD3Config(**SMALL)
    rng = np.random.default_rng(0)
    jstate = jtd3.td3_init(jax.random.key(1), OBS, ACT, jcfg)
    state = td3_state_from_numpy(to_np(jstate), "cpu", cfg)
    update = jax.jit(lambda s, k, b: jtd3.td3_update(s, k, b, jcfg))
    for i in range(4):
        batch = (rng.standard_normal((B, OBS)), np.tanh(rng.standard_normal((B, ACT))),
                 rng.standard_normal(B), rng.standard_normal((B, OBS)),
                 (rng.random(B) < 0.2) * 1.0)
        batch = tuple(np.asarray(b, np.float32) for b in batch)
        key = jax.random.key(10 + i)
        noise = jax.random.normal(key, (B, ACT))  # the draw td3_update makes
        before = [x.detach().clone() for x in networks.tree_leaves(
            (state.actor, state.target_actor, state.target_critic))]
        moments = {k: v["exp_avg"].clone() for k, v in state.actor_opt.state.items()}
        jstate, jm = update(jstate, key, tuple(map(jnp.asarray, batch)))
        state, m = td3.td3_update(state, None, tuple(map(t, batch)), cfg, noise=t(noise))
        ref = to_np(jstate)
        assert_trees_close(state.actor, ref.actor, mlp_from_numpy, what="actor")
        assert_trees_close(state.target_actor, ref.target_actor, mlp_from_numpy, what="t-actor")
        assert_trees_close(state.critic, ref.critic, critic_from_numpy, what="critic")
        assert_trees_close(state.target_critic, ref.target_critic, critic_from_numpy,
                           what="t-critic")
        for name in jm._fields:
            np.testing.assert_allclose(getattr(m, name).numpy(), np.asarray(getattr(jm, name)),
                                       rtol=1e-4, atol=1e-6, err_msg=name)
        count = int(ref.actor_opt[0].count)
        assert count == i // 2 + 1 and state.step == int(ref.step) == i + 1
        for st in state.actor_opt.state.values():
            assert float(st["step"]) == count
        after = networks.tree_leaves((state.actor, state.target_actor, state.target_critic))
        if i % 2:
            for a, b in zip(before, after):
                torch.testing.assert_close(a, b.detach(), atol=0, rtol=0)
            for k, v in state.actor_opt.state.items():
                torch.testing.assert_close(v["exp_avg"], moments[k], atol=0, rtol=0)
        else:
            assert all(not torch.equal(a, b.detach()) for a, b in zip(before, after))
    ref_mu = mlp_from_numpy(to_np(jstate.actor_opt[0].mu), "cpu")
    for leaf, mu in zip(networks.tree_leaves(state.actor), networks.tree_leaves(ref_mu)):
        np.testing.assert_allclose(state.actor_opt.state[leaf]["exp_avg"].numpy(), mu.numpy(),
                                   atol=1e-6)


# ---------------------------------------------------------------------------
# PPO
# ---------------------------------------------------------------------------


def jax_gae(value, reward, done, terminated, v_next, cfg):
    """The reverse scan inside the JAX package's ppo_rollout."""
    def gae_body(gae, inp):
        v, r, d, term, vn = inp
        delta = r + cfg.gamma * vn * (1 - term) - v
        gae = delta + cfg.gamma * cfg.gae_lambda * (1 - d) * gae
        return gae, gae

    _, adv = jax.lax.scan(gae_body, jnp.zeros_like(value[0]),
                          (value, reward, done, terminated, v_next), reverse=True)
    return np.asarray(adv)


def test_gae_matches_jax_and_the_manual_formula():
    cfg = ppo.PPOConfig(gamma=0.9, gae_lambda=0.8)
    value = np.asarray([[1.0], [2.0], [3.0], [4.0]], np.float32)
    reward = np.ones((4, 1), np.float32)
    terminated = np.asarray([[0.0], [1.0], [0.0], [0.0]], np.float32)
    done = np.asarray([[0.0], [1.0], [0.0], [1.0]], np.float32)  # t = 3 truncated
    v_next = np.asarray([[2.0], [9.9], [4.0], [5.0]], np.float32)
    adv = ppo.gae(*map(t, (value, reward, done, terminated, v_next)), cfg).numpy()
    expect, acc = np.zeros((4, 1)), 0.0
    for i in reversed(range(4)):
        delta = reward[i, 0] + cfg.gamma * v_next[i, 0] * (1 - terminated[i, 0]) - value[i, 0]
        acc = delta + cfg.gamma * cfg.gae_lambda * (1 - done[i, 0]) * acc
        expect[i, 0] = acc
    np.testing.assert_allclose(adv, expect, atol=1e-6)
    assert abs(expect[3, 0] - (1.0 + 0.9 * 5.0 - 4.0)) < 1e-6  # truncation bootstraps
    assert abs(expect[1, 0] - (1.0 - 2.0)) < 1e-6  # termination does not
    # random [H, N] with both kinds of boundary, against the JAX scan
    rng = np.random.default_rng(1)
    term = (rng.random((16, 8)) < 0.1).astype(np.float32)
    arrays = (rng.standard_normal((16, 8)), rng.standard_normal((16, 8)),
              np.maximum(term, rng.random((16, 8)) < 0.1), term,
              rng.standard_normal((16, 8)))
    arrays = tuple(np.asarray(a, np.float32) for a in arrays)
    jcfg = jppo.PPOConfig()
    np.testing.assert_allclose(ppo.gae(*map(t, arrays), ppo.PPOConfig()).numpy(),
                               jax_gae(*map(jnp.asarray, arrays), jcfg), atol=1e-6)


def env_state_from_jax(jes) -> EnvState:
    return EnvState(
        dynamics=state_from_numpy(to_np(jes.dynamics), "cpu"),
        action_history=torch.from_numpy(np.array(jes.action_history)),
        angvel_history=torch.from_numpy(np.array(jes.angvel_history)),
        t=torch.from_numpy(np.array(jes.t)),
    )


def test_ppo_rollout_matches_jax_from_handed_states():
    N, H = 6, 8
    jcfg = jppo.PPOConfig(rollout_length=H, actor_hidden=(16, 16), value_hidden=(16, 16))
    cfg = ppo.PPOConfig(rollout_length=H, actor_hidden=(16, 16), value_hidden=(16, 16))
    jenv = JL2F(JEnvConfig(init=JInitConfig(**GENTLE), termination=JTerminationConfig(**WIDE)))
    env = L2F(EnvConfig(init=InitConfig(**GENTLE), termination=TerminationConfig(**WIDE)))
    jparams = jsample(jax.random.key(1), N)
    jes, jobs = jax.vmap(jenv.reset)(jax.random.split(jax.random.key(2), N), jparams)
    jstate = jppo.ppo_init(jax.random.key(3), jenv.OBSERVATION_DIM, ACT, jcfg)
    key, noise = jax.random.key(4), []
    for _ in range(H):  # the draws ppo_rollout makes
        key, k_act = jax.random.split(key)
        noise.append(jax.random.normal(k_act, (N, ACT)))
    _, jobs2, _, ref = jppo.ppo_rollout(jstate, jenv, jparams, jes, jobs, jax.random.key(4), jcfg)
    state = ppo_state_from_numpy(to_np(jstate), "cpu", cfg)
    _, obs2, got = ppo.ppo_rollout(
        state, env, dynamics_params_from_numpy(to_np(jparams), "cpu"), env_state_from_jax(jes),
        t(jobs), torch.Generator().manual_seed(0), cfg, noise=t(np.stack(noise)))
    for name in ("obs", "raw_action", "logp", "advantage", "return"):
        assert got[name].shape == ref[name].shape
        np.testing.assert_allclose(got[name].numpy(), np.asarray(ref[name]), atol=2e-4,
                                   rtol=1e-5, err_msg=name)
    np.testing.assert_allclose(obs2.numpy(), np.asarray(jobs2), atol=2e-4)


def ppo_batch(rng, jstate, h, n):
    """A rollout-shaped batch whose old log-probs are off the current policy
    (so ratios clip) and whose advantages have a mean, a spread and few
    samples (so ddof matters)."""
    obs = rng.standard_normal((h, n, OBS)).astype(np.float32)
    mu, log_std = jnetworks.actor_dist(jstate.actor, jnp.asarray(obs))
    raw = np.asarray(mu) + np.exp(np.asarray(log_std)) * rng.standard_normal((h, n, ACT))
    logp = np.asarray(jppo._gaussian_logp(mu, log_std, jnp.asarray(raw, jnp.float32)))
    return {
        "obs": obs, "raw_action": raw.astype(np.float32),
        "logp": (logp + 0.3 * rng.standard_normal((h, n))).astype(np.float32),
        "advantage": (2.0 + 3.0 * rng.standard_normal((h, n))).astype(np.float32),
        "return": (5.0 * rng.standard_normal((h, n))).astype(np.float32),
    }


@pytest.mark.parametrize("max_grad_norm", [0.5, 1e6])
def test_ppo_update_matches_jax(max_grad_norm):
    """Two updates (2 epochs of 2 minibatches each) with JAX's permutations:
    every leaf, the Adam moments and the metrics agree. At 0.5 the global
    gradient norm over {actor, value} lies above the bound, at 1e6 below."""
    flags = dict(n_epochs=2, n_minibatches=2, actor_hidden=(16, 16), value_hidden=(16, 16),
                 max_grad_norm=max_grad_norm)
    jcfg, cfg = jppo.PPOConfig(**flags), ppo.PPOConfig(**flags)
    rng = np.random.default_rng(5)
    jstate = jppo.ppo_init(jax.random.key(6), OBS, ACT, jcfg)
    state = ppo_state_from_numpy(to_np(jstate), "cpu", cfg)
    update = jax.jit(lambda s, k, b: jppo.ppo_update(s, k, b, jcfg))
    for i in range(2):
        batch = ppo_batch(rng, jstate, 4, 4)
        if i == 0:  # the first minibatch's gradient norm, on the port's side
            adv = batch["advantage"].reshape(-1)
            mb = {k: t(v.reshape(16, *v.shape[2:])[:8]) for k, v in batch.items()}
            mb["advantage"] = t(((adv - adv.mean()) / (adv.std() + 1e-8))[:8])
            total, _ = ppo._loss(state, mb, cfg)
            grads = torch.autograd.grad(total, networks.tree_leaves(state.opt.param_groups[0]["params"]))
            norm = float(torch.sqrt(sum((g * g).sum() for g in grads)))
            assert (norm > max_grad_norm) == (max_grad_norm == 0.5)
            # ddof 0 and ddof 1 give normalised advantages 3 % apart here
            assert abs(adv.std(ddof=1) / adv.std(ddof=0) - 1.0) > 0.03
        key = jax.random.key(20 + i)
        perms = np.stack([np.asarray(jax.random.permutation(k, 16))
                          for k in jax.random.split(key, 2)])  # the draws ppo_update makes
        jstate, jm = update(jstate, key, {k: jnp.asarray(v) for k, v in batch.items()})
        state, m = ppo.ppo_update(state, None, {k: t(v) for k, v in batch.items()}, cfg,
                                  perms=torch.from_numpy(perms).long())
    ref = to_np(jstate)
    assert_trees_close(state.actor, ref.actor, mlp_from_numpy, what="actor")
    assert_trees_close(state.value, ref.value, mlp_from_numpy, what="value")
    assert state.step == int(ref.step) == 2
    for name in jm._fields:
        np.testing.assert_allclose(getattr(m, name).numpy(), np.asarray(getattr(jm, name)),
                                   rtol=1e-4, atol=1e-6, err_msg=name)
    adam = ref.opt[1][0]
    mus = networks.tree_leaves({"actor": mlp_from_numpy(adam.mu["actor"], "cpu"),
                                "value": mlp_from_numpy(adam.mu["value"], "cpu")})
    for leaf, mu in zip(networks.tree_leaves(state.opt.param_groups[0]["params"]), mus):
        np.testing.assert_allclose(state.opt.state[leaf]["exp_avg"].numpy(), mu.numpy(),
                                   atol=1e-6)
        assert float(state.opt.state[leaf]["step"]) == int(adam.count) == 8


def test_ppo_iteration_on_env():
    """The port's case of tests/test_td3_ppo_loop.py:33."""
    env = L2F(EnvConfig())
    cfg = ppo.PPOConfig(rollout_length=8, n_epochs=2, n_minibatches=2, actor_hidden=(16, 16),
                        value_hidden=(16, 16))
    gen = torch.Generator().manual_seed(0)
    params = sample_population(gen, 8)
    state = ppo.ppo_init(gen, env.OBSERVATION_DIM, ACT, cfg)
    es, obs = env.reset(params, gen)
    it = ppo.make_ppo_iteration(env, cfg)
    for _ in range(2):
        state, es, obs, gen, metrics = it(state, params, es, obs, gen)
    assert state.step == 2 and all(bool(torch.isfinite(x)) for x in metrics)


# ---------------------------------------------------------------------------
# the generic runner and the loop
# ---------------------------------------------------------------------------

RUN_SMALL = dict(n_envs=8, rollout_length=4, gradient_steps=4, batch_size=32, replay_capacity=64)


@pytest.mark.parametrize("algo", ["sac", "td3"])
def test_generic_super_step_runs(algo):
    env = L2F(EnvConfig())
    run_cfg = runner.RunnerConfig(**RUN_SMALL)
    spec = (runner_generic.sac_spec(sac.SACConfig(**SMALL)) if algo == "sac"
            else runner_generic.td3_spec(td3.TD3Config(**SMALL)))
    gen = torch.Generator().manual_seed(1)
    params = sample_population(gen, 8)
    state = runner_generic.generic_trainer_init(gen, env, params, run_cfg, spec)
    step = runner_generic.make_generic_super_step(env, run_cfg, spec)
    for _ in range(2):
        state, metrics = step(state, params)
    assert state.total_env_steps == 2 * 4 * 8 and state.buffer.size == 8
    assert state.learner.step == 8
    assert all(bool(torch.isfinite(x).all()) for x in metrics)


def test_loop_steps_cadence(tmp_path):
    """The port's case of tests/test_td3_ppo_loop.py:99: the same counts."""
    calls = {"eval": 0, "ckpt": 0}

    def fake_super_step(state, params):
        return state + 1, {"loss": 1.0}

    def fake_eval(state):
        calls["eval"] += 1
        return {"return/mean": 10.0}

    def fake_save(state, step):
        calls["ckpt"] += 1

    run = Run(base_dir=str(tmp_path), experiment="loop-test")
    holder = loop.StateHolder(state=0, env_steps_per_iter=100)
    training_loop = loop.Loop(
        loop.CoreStep(fake_super_step, params=None),
        loop.EvaluationStep(fake_eval, every_env_steps=300),
        loop.CheckpointStep(fake_save, every_env_steps=500),
        loop.TimingStep(log_every_iters=2),
        loop.ExtrackStep(),
        extrack_run=run,
    )
    training_loop.run_until(holder, 1000)
    run.close()
    assert holder.state == 10
    assert calls["eval"] == 3  # at 300, 600, 900
    assert calls["ckpt"] == 2  # at 500, 1000


# ---------------------------------------------------------------------------
# guards
# ---------------------------------------------------------------------------


def test_nonfinite_detection_names_each_path():
    gen = torch.Generator().manual_seed(0)
    state = td3.td3_init(gen, OBS, ACT, td3.TD3Config(**SMALL))
    assert guards.nonfinite_leaves(state) == []
    with torch.no_grad():
        state.critic["q2"]["layers"][1]["b"][3] = float("nan")
    assert guards.nonfinite_leaves(state) == [".critic['q2']['layers'][1]['b']"]
    with pytest.raises(FloatingPointError):
        guards.check_pytree(state)
    sick = {"a": torch.ones(3), "b": (torch.tensor([1.0, float("inf")]), 3)}
    assert guards.nonfinite_leaves(sick) == ["['b'][0]"]


def test_failure_step_rolls_back_a_float_state():
    """The port's case of tests/test_guards.py:19."""
    snapshots = []

    def super_step(state, params):
        new = state + 1.0
        return new, {"loss": float("nan") if new == 5.0 else 1.0}

    detector = guards.FailureDetectionStep(every_iters=1, snapshot_fn=snapshots.append,
                                           restore_fn=lambda: snapshots[-1] + 0.5)
    holder = loop.StateHolder(state=0.0, env_steps_per_iter=1)
    training = loop.Loop(loop.CoreStep(super_step, None), detector)
    for _ in range(10):
        training.step(holder)
    assert detector.restores == 1 and holder.state > 5.0 and snapshots
    raising = loop.Loop(loop.CoreStep(lambda s, p: (s + 1, {"loss": float("nan")}), None),
                        guards.FailureDetectionStep(every_iters=1))
    with pytest.raises(guards.DivergenceError):
        raising.step(loop.StateHolder(state=0, env_steps_per_iter=1))


def test_guard_rolls_an_in_place_learner_back_to_the_values_before_the_nan():
    """A TD3 trainer through the loop; a NaN put into its critic after a
    healthy check makes the guard restore the snapshot: parameters, Adam
    moments, ring, generator and counters equal those before the NaN, in
    the same objects."""
    env = L2F(EnvConfig())
    run_cfg = runner.RunnerConfig(**RUN_SMALL)
    spec = runner_generic.td3_spec(td3.TD3Config(**SMALL))
    gen = torch.Generator().manual_seed(2)
    params = sample_population(gen, 8)
    state = runner_generic.generic_trainer_init(gen, env, params, run_cfg, spec)
    step = runner_generic.make_generic_super_step(env, run_cfg, spec)
    snap = guards.Snapshot()
    detector = guards.FailureDetectionStep(every_iters=1, check_state=True,
                                           snapshot_fn=snap.take, restore_fn=snap.restore)
    holder = loop.StateHolder(state, run_cfg.rollout_length * run_cfg.n_envs)
    training = loop.Loop(loop.CoreStep(step, params), detector)
    training.step(holder)
    good = [(p, guards._copy(leaf)) for p, _, _, leaf in sck.leaves_with_path(state)]
    critic_w = state.learner.critic["q1"]["layers"][0]["w"]
    actor_opt = state.learner.actor_opt

    def poisoned(state, params):
        state, metrics = step(state, params)
        with torch.no_grad():
            state.learner.critic["q1"]["layers"][0]["w"][0, 0] = float("nan")
        return state, metrics

    training.steps[0].super_step = poisoned
    training.step(holder)
    assert detector.restores == 1 and holder.state is state
    assert state.learner.critic["q1"]["layers"][0]["w"] is critic_w
    assert state.learner.actor_opt is actor_opt
    for (path, before), (p, _, _, leaf) in zip(good, sck.leaves_with_path(state)):
        assert path == p
        if isinstance(leaf, torch.Tensor):
            torch.testing.assert_close(leaf.detach(), before, atol=0, rtol=0, msg=path)
        elif isinstance(leaf, torch.optim.Optimizer):
            restored = leaf.state_dict()["state"]
            for i, st in before.items():
                for k, v in st.items():
                    torch.testing.assert_close(restored[i][k], v, atol=0, rtol=0)
        elif isinstance(leaf, torch.Generator):
            assert torch.equal(leaf.get_state(), before)
        else:
            assert leaf == before, path
    assert guards.nonfinite_leaves(state) == []
    # training goes on from the restored state
    training.steps[0].super_step = step
    training.step(holder)
    assert guards.nonfinite_leaves(state) == [] and detector.restores == 1


# ---------------------------------------------------------------------------
# state checkpoints and profiling
# ---------------------------------------------------------------------------


def test_roundtrip_simple(tmp_path):
    gen = torch.Generator().manual_seed(7)
    tree = {"a": torch.arange(5.0), "b": {"c": torch.ones(2, 3), "g": gen}, "n": [3, 2.5]}
    sck.save_pytree(str(tmp_path / "state_100"), tree)
    expect = torch.randn(3, generator=gen)
    template = {"a": torch.zeros(5), "b": {"c": torch.zeros(2, 3),
                                          "g": torch.Generator().manual_seed(0)}, "n": [0, 0.0]}
    got = sck.restore_pytree(str(tmp_path / "state_100"), template)
    assert got is template and got["n"] == [3, 2.5] and isinstance(got["n"][0], int)
    np.testing.assert_array_equal(got["a"].numpy(), np.arange(5.0))
    # the restored generator continues the saved stream
    torch.testing.assert_close(torch.randn(3, generator=got["b"]["g"]), expect, atol=0, rtol=0)
    assert sck.latest_checkpoint(str(tmp_path)) == (str(tmp_path / "state_100"), 100)
    assert not os.path.exists(str(tmp_path / "state_100.tmp.npz"))
    desc = json.load(open(str(tmp_path / "state_100.treedef.json")))
    assert desc["paths"] == ["['a']", "['b']['c']", "['b']['g']", "['n'][0]", "['n'][1]"]
    with pytest.raises(ValueError, match="shape"):
        sck.restore_pytree(str(tmp_path / "state_100"), dict(template, a=torch.zeros(6)))
    with pytest.raises(ValueError, match="structure"):
        sck.restore_pytree(str(tmp_path / "state_100"), {"a": torch.zeros(5)})


def test_resume_reproduces_training_bit_for_bit(tmp_path):
    """The port's case of tests/test_state_checkpoint.py:26: save the SAC
    trainer state mid-training, restore it into a freshly made trainer, and
    continue: the same metrics and parameters as the uninterrupted run, bit
    for bit."""
    env = L2F(EnvConfig())
    run_cfg = runner.RunnerConfig(**RUN_SMALL)
    sac_cfg = sac.SACConfig(**SMALL)
    gen = torch.Generator().manual_seed(0)
    params = sample_population(gen, 8)
    state = runner.trainer_init(torch.Generator().manual_seed(1), env, params, run_cfg, sac_cfg)
    super_step = runner.make_super_step(env, run_cfg, sac_cfg)
    state, _ = super_step(state, params)
    sck.save_pytree(str(tmp_path / "state_1"), state)

    state_a, metrics_a = super_step(state, params)  # branch A: go on
    template = runner.trainer_init(torch.Generator().manual_seed(99), env, params, run_cfg,
                                   sac_cfg)
    restored = sck.restore_pytree(str(tmp_path / "state_1"), template)
    state_b, metrics_b = super_step(restored, params)  # branch B: from disk
    for a, b in zip(metrics_a, metrics_b):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    for a, b in zip(sck.leaves_with_path(state_a), sck.leaves_with_path(state_b)):
        if isinstance(a[3], torch.Tensor):
            torch.testing.assert_close(a[3], b[3], atol=0, rtol=0, msg=a[0])
    assert state_b.total_env_steps == state_a.total_env_steps == 2 * 4 * 8
    assert state_b.sac.step == state_a.sac.step


def test_device_trace_writes_a_chrome_trace_with_program_spans(tmp_path):
    x = torch.randn(64, 64)
    with profiling.device_trace(str(tmp_path / "trace")) as prof:
        with profiling.span("matmul"):
            (x @ x).sum()
    trace = json.load(open(str(tmp_path / "trace" / "trace.json")))
    assert any("mm" in ev.get("name", "") for ev in trace["traceEvents"])
    assert any("mm" in e.key for e in prof.key_averages())
    ranges = [ev for ev in trace["traceEvents"] if ev.get("name") == "raptor.matmul"]
    assert ranges and ranges[0].get("ph") == "X" and ranges[0]["dur"] > 0
