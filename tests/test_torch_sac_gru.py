"""The recurrent learner (`raptor_tpu_torch/rl/sac_gru.py`, `rl/runner_gru.py`
and `SequenceBuffer` in `rl/replay.py`) against the JAX package, on the CPU.

States, batches and noise are made with numpy or JAX and handed across as
numpy arrays; the JAX side runs as its own tests run it (f32 matmuls at
"highest", tests/conftest.py). Tolerances: the ring's writes and its sampled
windows exact; `actor_forward` / `critic_forward` 2e-6; `sac_gru_update` 1e-5
on every leaf and rtol 1e-4 on the metrics after three updates (the bars of
tests/test_torch_sac.py); the graft 1e-6 (tests/test_sac_gru.py:214);
`collect_sequences` 2e-4 over the rollout (the collect tolerance of
tests/test_torch_pretraining.py).
"""

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
from raptor_tpu.rl import replay as jreplay
from raptor_tpu.rl import runner_gru as jrunner_gru
from raptor_tpu.rl import sac_gru as jsac_gru
from raptor_tpu_torch.checkpoint import (
    dynamics_params_from_numpy, from_numpy, h5, sac_gru_state_from_numpy,
    sequence_buffer_from_numpy, state_from_numpy,
)
from raptor_tpu_torch.env import EnvConfig, InitConfig, L2F, TerminationConfig
from raptor_tpu_torch.env.quad import EnvState
from raptor_tpu_torch.policy import network as gru_net
from raptor_tpu_torch.rl import networks, replay, runner_gru, sac_gru

STUDENT = "raptor_tpu_torch/data/student_rateFlagCurPure.npz"
GENTLE = dict(max_angle=0.2, linear_velocity_std=0.02, angular_velocity_std=0.02)
WIDE = dict(position_bound=50.0, angular_velocity_bound=1000.0)
B, T, ACT = 4, 10, 4


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def t(x):
    return torch.from_numpy(np.array(x, np.float32))


# ---------------------------------------------------------------------------
# SequenceBuffer
# ---------------------------------------------------------------------------


def test_config_defaults_equal_jax():
    import dataclasses

    for mine, ref in ((sac_gru.SACGRUConfig(), jsac_gru.SACGRUConfig()),
                      (runner_gru.GRURunnerConfig(), jrunner_gru.GRURunnerConfig())):
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)


@pytest.mark.parametrize("n_rollouts", [1, 3])
def test_sequence_buffer_add_and_sample_are_jax_bit_for_bit(n_rollouts):
    """Writes across a wrap of the ring, then windows at JAX's own draws:
    equal bit for bit. One rollout leaves size 4 < T = 6 (every window starts
    at 0); three wrap a ring of 10."""
    C, N, D, H, seq = 10, 3, 5, 4, 6
    rng = np.random.default_rng(0)
    jbuf = jreplay.sequence_buffer_init(C, N, D, 2)
    buf = replay.sequence_buffer_init(C, N, D, 2, "cpu")
    for _ in range(n_rollouts):
        rows = (rng.standard_normal((H, N, D)), rng.standard_normal((H, N, 2)),
                rng.standard_normal((H, N)), (rng.random((H, N)) < 0.3) * 1.0,
                (rng.random((H, N)) < 0.3) * 1.0)
        rows = tuple(np.asarray(r, np.float32) for r in rows)
        jbuf = jreplay.sequence_buffer_add_rollout(jbuf, *map(jnp.asarray, rows))
        replay.sequence_buffer_add_rollout(buf, *map(t, rows))
    assert (buf.ptr, buf.size) == (int(jbuf.ptr), int(jbuf.size))
    for name in ("obs", "action", "reward", "done", "reset"):
        np.testing.assert_array_equal(getattr(buf, name).numpy(), np.asarray(getattr(jbuf, name)))
    key = jax.random.key(7)
    ref = jreplay.sequence_buffer_sample(jbuf, key, 16, seq)
    kt, ke = jax.random.split(key)  # the draws sequence_buffer_sample makes
    t0 = jax.random.randint(kt, (16,), 0, max(int(jbuf.size) - seq, 1))
    e_idx = jax.random.randint(ke, (16,), 0, N)
    got = replay.sequence_buffer_sample(
        buf, None, 16, seq, idx=(torch.from_numpy(np.array(t0)).long(),
                                 torch.from_numpy(np.array(e_idx)).long()))
    assert got["obs"].shape == (16, seq, D)
    for name in ("obs", "action", "reward", "done", "reset", "env_idx"):
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(ref[name]), err_msg=name)
    if n_rollouts == 1:
        assert int(t0.max()) == 0
    # drawn from the generator: windows inside the filled logical range
    gen = torch.Generator().manual_seed(0)
    drawn = replay.sequence_buffer_sample(buf, gen, 64, seq)
    assert drawn["reset"].shape == (64, seq) and int(drawn["env_idx"].max()) < N


# ---------------------------------------------------------------------------
# forward passes and the update
# ---------------------------------------------------------------------------


def window_np(rng, obs_dim, b=B, steps=T):
    return {
        "obs": rng.standard_normal((b, steps, obs_dim)).astype(np.float32),
        "action": np.tanh(rng.standard_normal((b, steps, ACT))).astype(np.float32),
        "reward": rng.standard_normal((b, steps)).astype(np.float32),
        "done": (rng.random((b, steps)) < 0.1).astype(np.float32),
        "reset": (rng.random((b, steps)) < 0.2).astype(np.float32),
    }


def test_actor_and_critic_forward_with_resets_mid_window_match_jax():
    rng = np.random.default_rng(1)
    cfg = jsac_gru.SACGRUConfig()
    jstate = jsac_gru.sac_gru_init(jax.random.key(2), 22, ACT, cfg)
    # a non-zero learned h0, so a re-injection is visible
    jstate.actor["gru_1"]["initial_hidden_state"] = jnp.asarray(
        rng.standard_normal(16).astype(np.float32))
    jstate.critic1["gru_1"]["initial_hidden_state"] = jnp.asarray(
        rng.standard_normal(16).astype(np.float32))
    w = window_np(rng, 22)
    reset = w["reset"].T.copy()
    reset[0] = 1.0
    reset[5, :2] = 1.0
    obs, act = w["obs"].swapaxes(0, 1), w["action"].swapaxes(0, 1)
    ref_mu, ref_ls = jsac_gru.actor_forward(jstate.actor, jnp.asarray(obs), jnp.asarray(reset), cfg)
    ref_q = jsac_gru.critic_forward(jstate.critic1, jnp.asarray(obs), jnp.asarray(act),
                                    jnp.asarray(reset))
    actor, critic = from_numpy(to_np(jstate.actor), "cpu"), from_numpy(to_np(jstate.critic1), "cpu")
    mu, ls = sac_gru.actor_forward(actor, t(obs), t(reset), sac_gru.SACGRUConfig())
    q = sac_gru.critic_forward(critic, t(obs), t(act), t(reset))
    assert mu.shape == (T, B, ACT) and q.shape == (T, B)
    np.testing.assert_allclose(mu.numpy(), np.asarray(ref_mu), atol=2e-6, rtol=0)
    np.testing.assert_allclose(ls.numpy(), np.asarray(ref_ls), atol=2e-6, rtol=0)
    np.testing.assert_allclose(q.numpy(), np.asarray(ref_q), atol=2e-6, rtol=0)
    # without the mid-window resets the answer differs: the re-injection counts
    reset[5, :2] = 0.0
    q2 = sac_gru.critic_forward(critic, t(obs), t(act), t(reset))
    assert float((q2 - q)[5:, :2].abs().max()) > 1e-3
    torch.testing.assert_close(q2[:, 2:], q[:, 2:], atol=0, rtol=0)


def jax_noise(key, mu_shape):
    """The noise sac_gru_update draws from its key: k_next, k_pi = split(key)."""
    k_next, k_pi = jax.random.split(key)
    return jax.random.normal(k_next, mu_shape), jax.random.normal(k_pi, mu_shape)


UPDATE_CASES = {
    "symmetric": dict(),
    "symmetric-burn4": dict(burn_in=4),
    "privileged-critic32": dict(actor_obs_dim=22, critic_hidden_dim=32),
    "privileged-burn4-critic24": dict(actor_obs_dim=22, burn_in=4, critic_hidden_dim=24),
}


@pytest.mark.parametrize("case", sorted(UPDATE_CASES))
def test_three_sac_gru_updates_match_jax(case):
    flags = UPDATE_CASES[case]
    jcfg, cfg = jsac_gru.SACGRUConfig(**flags), sac_gru.SACGRUConfig(**flags)
    obs_dim = 31 if "actor_obs_dim" in flags else 22
    rng = np.random.default_rng(3)
    jstate = jsac_gru.sac_gru_init(jax.random.key(4), obs_dim, ACT, jcfg)
    state = sac_gru_state_from_numpy(to_np(jstate), "cpu", cfg)
    update = jax.jit(lambda s, k, b: jsac_gru.sac_gru_update(s, k, b, jcfg))
    for i in range(3):
        w = window_np(rng, obs_dim)
        key = jax.random.key(100 + i)
        noise = jax_noise(key, (T, B, ACT))
        jstate, jm = update(jstate, key, {k: jnp.asarray(v) for k, v in w.items()})
        state, m = sac_gru.sac_gru_update(state, None, {k: t(v) for k, v in w.items()}, cfg,
                                          noise=tuple(t(np.asarray(n)) for n in noise))
    ref = to_np(jstate)
    for name in ("actor", "critic1", "critic2", "target1", "target2"):
        mine, theirs = getattr(state, name), from_numpy(getattr(ref, name), "cpu")
        for a, b in zip(networks.tree_leaves(mine), networks.tree_leaves(theirs)):
            np.testing.assert_allclose(a.detach().numpy(), b.numpy(), atol=1e-5, rtol=0,
                                       err_msg=name)
    np.testing.assert_allclose(state.log_alpha.detach().numpy(), ref.log_alpha, atol=1e-5)
    assert state.step == int(ref.step) == 3
    for name in jm._fields:
        np.testing.assert_allclose(getattr(m, name).numpy(), np.asarray(getattr(jm, name)),
                                   rtol=1e-4, atol=1e-6, err_msg=name)
    # one Adam over both critics: the moments split in order, one shared count
    adam = ref.critic_opt[0]
    mus = networks.tree_leaves((from_numpy(adam.mu[0], "cpu"), from_numpy(adam.mu[1], "cpu")))
    leaves = networks.tree_leaves((state.critic1, state.critic2))
    assert len(mus) == len(leaves)
    for leaf, mu in zip(leaves, mus):
        st = state.critic_opt.state[leaf]
        np.testing.assert_allclose(st["exp_avg"].numpy(), mu.numpy(), atol=1e-6)
        assert float(st["step"]) == float(adam.count) == 3.0
    if "actor_obs_dim" in flags:
        assert state.actor["dense_0"]["weights"].shape == (16, 22)
        assert state.critic1["dense_0"]["weights"].shape[1] == 31 + ACT
        assert state.critic1["gru_1"]["initial_hidden_state"].shape == (flags["critic_hidden_dim"],)


def test_update_reaches_every_leaf_and_leaves_no_gradient():
    gen = torch.Generator().manual_seed(0)
    state = sac_gru.sac_gru_init(gen, 22, ACT)
    before = {n: [x.detach().clone() for x in networks.tree_leaves(getattr(state, n))]
              for n in ("actor", "critic1", "target1")}
    w = window_np(np.random.default_rng(5), 22)
    state, m = sac_gru.sac_gru_update(state, gen, {k: t(v) for k, v in w.items()})
    assert state.step == 1 and all(bool(torch.isfinite(x)) for x in m)
    for n, old in before.items():
        new = networks.tree_leaves(getattr(state, n))
        # every weight and the learned h0 moved (h0 through the re-injections)
        assert all(not torch.equal(a, b.detach()) for a, b in zip(old, new)), n
    for leaf in (*networks.tree_leaves((state.actor, state.critic1, state.critic2)),
                 state.log_alpha):
        assert leaf.grad is None and leaf.requires_grad


def critic_loss_of(batch, cfg=sac_gru.SACGRUConfig(), obs_dim=6, act=2):
    """The critic loss of one update from one fixed initial state and noise."""
    state = sac_gru.sac_gru_init(torch.Generator().manual_seed(0), obs_dim, act, cfg)
    bsz, steps = batch["reward"].shape
    noise = tuple(torch.from_numpy(np.random.default_rng(9).standard_normal(
        (steps, bsz, act)).astype(np.float32)) for _ in range(2))
    return sac_gru.sac_gru_update(state, None, batch, cfg, noise=noise)


def test_boundary_masking_excludes_cross_episode_targets():
    """The port's case of tests/test_sac_gru.py:49: a reward spike right
    before a truncation seam leaves the critic loss unchanged; on a valid
    transition it changes it massively."""
    w = window_np(np.random.default_rng(1), 6, b=2, steps=6)
    w["action"] = w["action"][..., :2]
    w["done"][:] = 0.0
    w["reset"][:] = 0.0
    base = {k: t(v) for k, v in w.items()}
    b1 = dict(base, reset=base["reset"].clone())
    b1["reset"][0, 3] = 1.0  # a seam at t = 3 of row 0
    b1_spiked = dict(b1, reward=b1["reward"].clone())
    b1_spiked["reward"][0, 2] = 1e6  # on the transition into the seam
    loss = lambda b: float(critic_loss_of(b)[1].critic_loss)  # noqa: E731
    assert abs(loss(b1) - loss(b1_spiked)) < 1e-3
    b2_spiked = dict(base, reward=base["reward"].clone())
    b2_spiked["reward"][0, 4] = 1e6
    assert abs(loss(base) - loss(b2_spiked)) > 1e6
    # a terminal transition stays in the loss (its target is r alone)
    b3 = dict(b1_spiked, done=b1["done"].clone())
    b3["done"][0, 2] = 1.0
    assert abs(loss(b3) - loss(b1)) > 1e6


def test_burn_in_masks_losses_but_warms_hidden():
    """The port's case of tests/test_sac_gru.py:158."""
    cfg = sac_gru.SACGRUConfig(burn_in=4)
    w = window_np(np.random.default_rng(1), 22, steps=12)
    w["done"][:] = 0.0
    b1 = {k: t(v) for k, v in w.items()}
    b2 = dict(b1, reward=b1["reward"].clone())
    b2["reward"][:, :4] += 1e3  # rewards inside the burn-in window only
    s1, m1 = critic_loss_of(b1, cfg, 22, ACT)
    s2, m2 = critic_loss_of(b2, cfg, 22, ACT)
    for name in ("actor", "critic1", "critic2", "target1", "target2"):
        for a, b in zip(networks.tree_leaves(getattr(s1, name)),
                        networks.tree_leaves(getattr(s2, name))):
            torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert float(m1.critic_loss) == float(m2.critic_loss)
    # the burn-in observations still warm the hidden state
    b1nr = dict(b1, reset=torch.zeros_like(b1["reset"]))
    b3 = dict(b1nr, obs=b1["obs"].clone())
    b3["obs"][:, :4] += 3.0
    assert float(critic_loss_of(b3, cfg, 22, ACT)[1].critic_loss) != float(
        critic_loss_of(b1nr, cfg, 22, ACT)[1].critic_loss)
    # burn_in = 0: the early rewards count
    cfg0 = sac_gru.SACGRUConfig(burn_in=0)
    assert float(critic_loss_of(b1, cfg0, 22, ACT)[1].critic_loss) != float(
        critic_loss_of(b2, cfg0, 22, ACT)[1].critic_loss)


def test_graft_actor_from_student_matches_tanh_of_student():
    """The committed student grafted: tanh(mu) equals tanh of the student's
    action at 1e-6 over a sequence, log-std is -2, and the grafted tree is
    the JAX package's graft of the same student."""
    student_np = h5.load_actor(STUDENT)
    jlearner = jsac_gru.sac_gru_init(jax.random.key(0), 22, ACT)
    ref = to_np(jsac_gru.graft_actor_from_student(jlearner.actor, student_np, ACT, -2.0))
    learner = sac_gru_state_from_numpy(to_np(jlearner), "cpu")
    actor = sac_gru.graft_actor_from_student(learner.actor, student_np, ACT, -2.0)
    for layer in ref:
        for k in ref[layer]:
            np.testing.assert_array_equal(actor[layer][k].numpy(), ref[layer][k])
    obs = np.random.default_rng(2).standard_normal((7, 3, 22)).astype(np.float32) * 0.5
    reset = torch.zeros(7, 3)
    reset[0] = 1.0
    mu, log_std = sac_gru.actor_forward(actor, t(obs), reset, sac_gru.SACGRUConfig())
    _, raw = gru_net.apply_sequence(from_numpy(student_np, "cpu"), t(obs))
    np.testing.assert_allclose(torch.tanh(mu).numpy(), torch.tanh(raw).numpy(), atol=1e-6)
    np.testing.assert_allclose(log_std.numpy(), -2.0, atol=1e-6)
    # set_actor: a fresh Adam over the grafted leaves
    sac_gru.set_actor(learner, actor, sac_gru.SACGRUConfig())
    assert learner.actor_opt.state == {} and all(x.requires_grad for x in
                                                  networks.tree_leaves(learner.actor))


# ---------------------------------------------------------------------------
# collect_sequences
# ---------------------------------------------------------------------------


def env_state_from_jax(jes) -> EnvState:
    return EnvState(
        dynamics=state_from_numpy(to_np(jes.dynamics), "cpu"),
        action_history=torch.from_numpy(np.array(jes.action_history)),
        angvel_history=torch.from_numpy(np.array(jes.angvel_history)),
        t=torch.from_numpy(np.array(jes.t)),
    )


def test_collect_sequences_matches_jax_from_handed_states():
    """H steps from a carried-across trainer state with JAX's own action
    noise, gentle starts inside wide bounds so that no env resets: the ring's
    rows, the carried hidden state and the observations agree."""
    N, H = 6, 8
    jenv = JL2F(JEnvConfig(init=JInitConfig(**GENTLE), termination=JTerminationConfig(**WIDE)))
    env = L2F(EnvConfig(init=InitConfig(**GENTLE), termination=TerminationConfig(**WIDE)))
    jrun = jrunner_gru.GRURunnerConfig(n_envs=N, rollout_length=H, replay_capacity=12)
    run_cfg = runner_gru.GRURunnerConfig(n_envs=N, rollout_length=H, replay_capacity=12)
    jcfg, cfg = jsac_gru.SACGRUConfig(actor_obs_dim=22), sac_gru.SACGRUConfig(actor_obs_dim=22)
    jparams = jsample(jax.random.key(1), N)
    js = jrunner_gru.gru_trainer_init(jax.random.key(2), jenv, jparams, jrun, jcfg)
    # a non-zero h0, so the reset before step 0 is visible
    js.learner.actor["gru_1"]["initial_hidden_state"] = jnp.full((16,), 0.3, jnp.float32)
    js = js.replace(hidden=jnp.zeros_like(js.hidden))
    key, noise = js.key, []
    for _ in range(H):  # the draws collect_sequences makes
        key, k_act, _ = jax.random.split(key, 3)
        noise.append(jax.random.normal(k_act, (N, ACT)))
    state = runner_gru.GRUTrainerState(
        learner=sac_gru_state_from_numpy(to_np(js.learner), "cpu", cfg),
        buffer=sequence_buffer_from_numpy(to_np(js.buffer), "cpu"),
        env_state=env_state_from_jax(js.env_state), obs=t(js.obs), hidden=t(js.hidden),
        just_reset=t(js.just_reset), generator=torch.Generator().manual_seed(0),
        total_env_steps=0)
    js = jrunner_gru.collect_sequences(js, jenv, jparams, jrun, jcfg)
    params = dynamics_params_from_numpy(to_np(jparams), "cpu")
    state = runner_gru.collect_sequences(state, env, params, run_cfg, cfg,
                                         noise=t(np.stack(noise)))
    assert (state.buffer.ptr, state.buffer.size, state.total_env_steps) == (
        int(js.buffer.ptr), int(js.buffer.size), int(js.total_env_steps))
    for name in ("obs", "action", "reward", "done", "reset"):
        np.testing.assert_allclose(getattr(state.buffer, name).numpy(),
                                   np.asarray(getattr(js.buffer, name)), atol=2e-4, rtol=0,
                                   err_msg=name)
    assert float(state.buffer.done.sum()) == 0.0 and float(state.buffer.reset[1:H].sum()) == 0.0
    assert float(state.buffer.reset[0].min()) == 1.0
    np.testing.assert_allclose(state.hidden.numpy(), np.asarray(js.hidden), atol=2e-4)
    np.testing.assert_allclose(state.obs.numpy(), np.asarray(js.obs), atol=2e-4)
    assert float(state.just_reset.sum()) == 0.0
    assert float(state.buffer.action[:H].abs().max()) > 0.5


def test_gru_runner_super_steps_on_the_cpu():
    """The port's cases of tests/test_sac_gru.py:70 and :92: two super-steps
    in each mode, the counters, the carried hidden and finite metrics."""
    env = L2F(EnvConfig())
    run_cfg = runner_gru.GRURunnerConfig(n_envs=8, rollout_length=8, gradient_steps=2,
                                         batch_size=4, sample_seq_len=8, replay_capacity=64)
    for cfg in (sac_gru.SACGRUConfig(),
                sac_gru.SACGRUConfig(actor_obs_dim=22, critic_hidden_dim=32)):
        gen = torch.Generator().manual_seed(0)
        from raptor_tpu_torch.env import sample_population

        params = sample_population(gen, 8)
        state = runner_gru.gru_trainer_init(gen, env, params, run_cfg, cfg)
        step = runner_gru.make_gru_multi_step(env, run_cfg, cfg, 2)
        state, metrics = step(state, params)
        assert state.total_env_steps == 2 * 8 * 8 and state.buffer.size == 16
        assert state.hidden.shape == (8, 16) and state.learner.step == 4
        assert all(bool(torch.isfinite(m)) for m in metrics)
        critic_in = state.learner.critic1["dense_0"]["weights"].shape[1]
        assert critic_in == (31 if cfg.actor_obs_dim else 22) + ACT
    with pytest.raises(ValueError):
        runner_gru.gru_trainer_init(gen, env, params, run_cfg,
                                    sac_gru.SACGRUConfig(actor_obs_dim=20))
