"""The port's distillation (`distill.post_training`, `distill.population`)
held to the JAX package at a small size (K = 4 teachers, M = 2 to 4 envs each,
T <= 30): airframes, teachers, student weights and initial states are made
by the JAX package or by numpy from a seed and handed to both sides.

Tolerances, each stated where it is used:
- labels (one MLP pass in f32): 1e-6; demonstrator labels 1e-5 (a 4x4 solve);
- collected observations over a 12-step closed loop: atol 2e-4, the JAX
  package's own tolerance for its collect kernel against its env;
- BPTT loss 1e-5; its gradients 1e-5 relative to the largest entry of the
  leaf; three Adam steps 1e-5 on every parameter;
- the learning-rate schedule 1e-7 (values are <= 1e-3).
The beta-mix draw, the permutations and the initial states come from a
`torch.Generator`, another stream than threefry: where they matter the test
checks distributions and invariants, not values.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from raptor_tpu.distill import population as jpopulation
from raptor_tpu.distill import post_training as jpt
from raptor_tpu.env import EnvConfig as JEnvConfig
from raptor_tpu.env import L2F as JL2F
from raptor_tpu.env.types import InitConfig as JInitConfig
from raptor_tpu.env.types import State as JState
from raptor_tpu.env.types import TerminationConfig as JTerminationConfig
from raptor_tpu.policy import network as jstudent_net
from raptor_tpu.rl import networks as jnetworks
from raptor_tpu_torch.checkpoint import from_numpy, state_from_numpy, teachers_from_numpy
from raptor_tpu_torch.distill import population
from raptor_tpu_torch.distill import post_training as pt
from raptor_tpu_torch.env import EnvConfig, InitConfig, L2F, TerminationConfig
from raptor_tpu_torch.env.types import tree_map
from raptor_tpu_torch.policy import network as student_net
from raptor_tpu_torch.rl import networks

K, M = 4, 2
GENTLE = dict(max_angle=0.2, linear_velocity_std=0.02, angular_velocity_std=0.02)
WIDE = dict(position_bound=50.0, angular_velocity_bound=1000.0)


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def leaves(student):
    return [(layer, name) for layer in student for name in student[layer]]


def as_leaf_params(student_np):
    """Port student from numpy arrays, leaves ready for autograd."""
    p = from_numpy(student_np, "cpu")
    for layer, name in leaves(p):
        p[layer][name].requires_grad_(True)
    return p


@pytest.fixture(scope="module")
def teachers():
    """K JAX-sampled airframes and K JAX-initialized (16, 16) actors, on both sides."""
    jframes = jpopulation.sample_teacher_airframes(jax.random.key(0), K)
    jactors = jax.vmap(lambda k: jnetworks.actor_init(k, 31, 4, (16, 16)))(
        jax.random.split(jax.random.key(1), K))
    # the default head scale (0.01) gives labels near 0: scale it up so labels spread
    jactors["layers"][-1]["w"] = jactors["layers"][-1]["w"] * 60.0
    tactors, tframes = teachers_from_numpy(to_np(jactors), to_np(jframes), "cpu")
    return jactors, jframes, tactors, tframes


@pytest.fixture(scope="module")
def student():
    p = to_np(jstudent_net.init_params(jax.random.key(2)))
    return p, from_numpy(p, "cpu")


def flat_both(teachers, m=M):
    _, jframes, _, tframes = teachers
    jflat = jax.tree.map(lambda x: jnp.repeat(x, m, axis=0), jframes)
    return jflat, population.flatten_envs(population.broadcast_airframe_to_envs(tframes, m))


def random_states(n, rng, angle=3.0):
    axis = rng.normal(0, 1, (n, 3))
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    ang = rng.uniform(0, angle, n)
    fields = dict(
        position=rng.normal(0, 0.2, (n, 3)),
        orientation=np.concatenate([np.cos(ang / 2)[:, None], axis * np.sin(ang / 2)[:, None]], -1),
        linear_velocity=rng.normal(0, 0.5, (n, 3)),
        angular_velocity=rng.normal(0, 4.0, (n, 3)),
        rpm=rng.uniform(0.2, 0.9, (n, 4)),
    )
    fields = {k: v.astype(np.float32) for k, v in fields.items()}
    return JState(**{k: jnp.asarray(v) for k, v in fields.items()}), state_from_numpy(fields, "cpu")


# ---------------------------------------------------------------------------
# config, population, labels
# ---------------------------------------------------------------------------


def test_config_and_teacher_mix_equal_jax():
    jf = {f.name: f.default for f in dataclasses.fields(jpt.DistillConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(pt.DistillConfig)}
    assert jf == tf
    for kwargs in ({}, dict(teacher_mix_decay_rounds=3), dict(teacher_mix_decay_rounds=0),
                   dict(teacher_mix_initial=0.8, teacher_mix_final=0.1)):
        for r in range(14):
            assert pt.teacher_mix(pt.DistillConfig(**kwargs), r) == jpt.teacher_mix(
                jpt.DistillConfig(**kwargs), r)


def test_population_broadcast_matches_jax(teachers):
    _, jframes, _, tframes = teachers
    jb = jpopulation.broadcast_airframe_to_envs(jframes, 3)
    tb = population.broadcast_airframe_to_envs(tframes, 3)
    for f in dataclasses.fields(tb):
        np.testing.assert_array_equal(getattr(tb, f.name).numpy(), np.asarray(getattr(jb, f.name)))
    flat = population.flatten_envs(tb)
    assert flat.mass.shape == (K * 3,) and flat.rotor_positions.shape == (K * 3, 4, 3)
    np.testing.assert_array_equal(flat.mass.numpy(), np.repeat(np.asarray(jframes.mass), 3))
    sampled = population.sample_teacher_airframes(torch.Generator().manual_seed(0), 64)
    jsampled = jpopulation.sample_teacher_airframes(jax.random.key(5), 64)
    assert sampled.mass.shape == (64,)
    # same distribution, another stream: compare the spread of the masses
    assert 0.5 < float(sampled.mass.mean()) / float(jsampled.mass.mean()) < 2.0
    assert float(sampled.disturbance_force_std.max()) == 0.0


def test_relabel_matches_jax_and_per_step_labels(teachers):
    jactors, _, tactors, _ = teachers
    jflat, tflat = flat_both(teachers)
    t = 7
    obs = np.random.default_rng(0).normal(0, 0.5, (t, K * M, 22)).astype(np.float32)
    want = np.asarray(jpt.make_relabel(JL2F())(jactors, jflat, jnp.asarray(obs)))
    env = L2F()
    got = pt.make_relabel(env)(tactors, tflat, torch.from_numpy(obs))
    assert got.shape == (t, K * M, 4)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    assert float(got.abs().max()) < 1.0 and float(got.std()) > 0.05
    # one batched pass == the in-loop labeler row by row
    label_fn = pt.make_labeler(env, pt.DistillConfig())
    tail = env.privileged_tail(tflat)
    _, state = random_states(K * M, np.random.default_rng(1))
    for row in range(t):
        full = torch.cat([torch.from_numpy(obs[row]), tail], -1)
        np.testing.assert_allclose(label_fn(tactors, tflat, full, state).numpy(),
                                   got[row].numpy(), atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match="privileged obs"):
        label_fn(tactors, tflat, torch.from_numpy(obs[0]), state)


@pytest.mark.parametrize("demo", [
    dict(demo_tilt=1.2),
    dict(demo_tilt=1.2, demo_rate=5.0),
    dict(demo_tilt=1.2, demo_rate=5.0, demo_adaptive=True, demo_w_cap=999.0, demo_k_w=999.0,
         demo_c_flip=0.5, demo_c_lag=1.2, demo_c_bw=3.0),
])
def test_labeler_with_demonstrator_matches_jax(teachers, demo):
    jactors, _, tactors, _ = teachers
    jflat, tflat = flat_both(teachers, 8)
    n = K * 8
    rng = np.random.default_rng(2)
    jstate, tstate = random_states(n, rng)
    obs_full = rng.normal(0, 0.5, (n, 31)).astype(np.float32)
    want = np.asarray(jpt.make_labeler(JL2F(), jpt.DistillConfig(**demo))(
        jactors, jflat, jnp.asarray(obs_full), jstate))
    got = pt.make_labeler(L2F(), pt.DistillConfig(**demo))(
        tactors, tflat, torch.from_numpy(obs_full), tstate).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    plain = pt.make_labeler(L2F(), pt.DistillConfig())(
        tactors, tflat, torch.from_numpy(obs_full), tstate).numpy()
    changed = np.any(got != plain, axis=-1)
    assert 0 < changed.sum() < n  # the demonstrator labels some states and not others
    if "demo_rate" in demo:
        only_tilt = pt.make_labeler(L2F(), pt.DistillConfig(demo_tilt=1.2))(
            tactors, tflat, torch.from_numpy(obs_full), tstate).numpy()
        assert changed.sum() > np.any(only_tilt != plain, axis=-1).sum()


# ---------------------------------------------------------------------------
# collect
# ---------------------------------------------------------------------------


class HandedL2F(L2F):
    """The port's env with initial states handed across, not sampled."""

    def __init__(self, config, states):
        super().__init__(config)
        self._states = states

    def sample_state(self, params, generator):
        return self._states


@pytest.mark.parametrize("case", ["beta0", "beta1", "demo"])
def test_collect_matches_jax_from_handed_initial_states(teachers, student, case):
    """12 closed-loop steps from gentle starts inside wide bounds (no env
    resets, so no further random draw matters): beta = 0 executes the
    student, beta = 1 the teachers, and the demo case flies half of each
    teacher's envs with the scripted demonstrator and labels tilted states
    with it."""
    jactors, jframes, tactors, tframes = teachers
    m, t = 4, 12
    extra = dict(demo_tilt=0.1, demo_rollout_frac=0.5) if case == "demo" else {}
    beta = 1.0 if case == "beta1" else 0.0
    jenv = JL2F(JEnvConfig(init=JInitConfig(**GENTLE), termination=JTerminationConfig(**WIDE)))
    tcfg = EnvConfig(init=InitConfig(**GENTLE), termination=TerminationConfig(**WIDE))
    key = jax.random.key(3)
    jdata = jpt.make_collect(jenv, jpt.DistillConfig(envs_per_teacher=m, rollout_length=t,
                                                     **extra))(
        student[0], jactors, jpopulation.broadcast_airframe_to_envs(jframes, m), key, beta)
    # the initial states the JAX collect drew from its key
    k_reset, _ = jax.random.split(key)
    jflat = jax.tree.map(lambda x: jnp.repeat(x, m, axis=0), jframes)
    es, _ = jax.vmap(jenv.reset)(jax.random.split(k_reset, K * m), jflat)
    tenv = HandedL2F(tcfg, state_from_numpy(to_np(es.dynamics), "cpu"))
    tdata = pt.make_collect(tenv, pt.DistillConfig(envs_per_teacher=m, rollout_length=t,
                                                   **extra))(
        student[1], tactors, population.broadcast_airframe_to_envs(tframes, m),
        torch.Generator().manual_seed(0), beta)
    assert tdata.obs.shape == (t, K * m, 22) and tdata.teacher_action.shape == (t, K * m, 4)
    assert float(np.asarray(jdata.reset).sum()) == 0.0
    np.testing.assert_array_equal(tdata.reset.numpy(), np.asarray(jdata.reset))
    np.testing.assert_allclose(tdata.obs.numpy(), np.asarray(jdata.obs), atol=2e-4, rtol=0)
    np.testing.assert_allclose(tdata.teacher_action.numpy(), np.asarray(jdata.teacher_action),
                               atol=2e-4, rtol=0)
    executed = tdata.obs[1:, :, 18:22]  # the action of step t is the next row's last 4 channels
    if case == "beta1":
        np.testing.assert_array_equal(executed.numpy(), tdata.teacher_action[:-1].numpy())
    elif case == "demo":
        # demonstrator-driven envs execute the demonstrator, which is also the
        # label wherever the state is tilted past demo_tilt
        driven = (torch.arange(K * m) % m) < 2
        tilted = pt.severe_mask(tdata.obs[:-1], 0.1)
        assert bool(tilted[:, driven].any()) and bool((~tilted)[:, driven].any())
        ran_label = (executed == tdata.teacher_action[:-1]).all(-1)
        assert bool(ran_label[:, driven][tilted[:, driven]].all())
        assert not bool(ran_label[:, ~driven].any())


def test_collect_mixes_teacher_actions_and_resets_the_hidden_state(teachers, student):
    _, _, tactors, tframes = teachers
    m, t = 16, 30
    env = L2F(EnvConfig(episode_length=7, init=InitConfig(**GENTLE),
                        termination=TerminationConfig(**WIDE)))
    env_params = population.broadcast_airframe_to_envs(tframes, m)
    collect = pt.make_collect(env, pt.DistillConfig(envs_per_teacher=m, rollout_length=t))
    gen = torch.Generator().manual_seed(4)
    data = collect(student[1], tactors, env_params, gen, 0.3)
    assert data.obs.shape == (t, K * m, 22) and data.reset.shape == (t, K * m)
    assert bool(torch.isfinite(data.obs).all()) and float(data.teacher_action.abs().max()) < 1.0
    # truncation every 7 steps, previous action zero on the row after a reset
    assert bool((data.reset[6] == 1).all()) and bool((data.reset[13] == 1).all())
    assert float(data.reset.sum()) == 4 * K * m
    assert float(data.obs[7, :, 18:22].abs().max()) == 0.0
    # share of executed actions that are the teacher's: beta +- 4 sigma
    cont = data.reset[:-1] == 0
    teacher_ran = (data.obs[1:, :, 18:22] == data.teacher_action[:-1]).all(-1)[cont]
    share = float(teacher_ran.float().mean())
    sigma = (0.3 * 0.7 / teacher_ran.numel()) ** 0.5
    assert abs(share - 0.3) < 4 * sigma, share
    # beta = 0: every executed action is the student's, with its hidden state
    # restarted where the env reset, exactly as BPTT replays it
    data0 = collect(student[1], tactors, env_params, gen, 0.0)
    replay = torch.clamp(pt.bptt_actions(student[1], data0.obs, data0.reset), -1.0, 1.0)
    cont0 = data0.reset[:-1] == 0
    np.testing.assert_allclose(data0.obs[1:, :, 18:22][cont0].numpy(), replay[:-1][cont0].numpy(),
                               atol=1e-6, rtol=0)
    carried = torch.clamp(
        pt.bptt_actions(student[1], data0.obs, torch.zeros_like(data0.reset)), -1.0, 1.0)
    assert not torch.allclose(carried[8:], replay[8:], atol=1e-4)


def test_fused_collect_round_trains_and_rejects_disturbances(teachers, student):
    _, _, tactors, tframes = teachers
    m, t = 4, 20
    env = L2F(EnvConfig(episode_length=8))
    cfg = pt.DistillConfig(envs_per_teacher=m, rollout_length=t, aggregate_capacity=32,
                           grad_steps_per_round=3, batch_size=8)
    env_params = population.broadcast_airframe_to_envs(tframes, m)
    relabel = pt.make_relabel(env)
    gen = torch.Generator().manual_seed(5)
    data = pt.fused_collect_round(student[1], tactors, env_params, gen, env, cfg, relabel)
    assert data.obs.shape == (t, K * m, 22) and data.teacher_action.shape == (t, K * m, 4)
    assert float(data.reset[7].mean()) > 0.9 and float(data.reset[:7].sum()) < K * m
    assert bool(torch.isfinite(data.teacher_action).all())
    again = pt.fused_collect_round(student[1], tactors, env_params,
                                   torch.Generator().manual_seed(5), env, cfg, relabel)
    assert torch.equal(again.obs, data.obs)  # the generator fixes states and the kernel seed
    other = pt.fused_collect_round(student[1], tactors, env_params, gen, env, cfg, relabel, seed=9)
    assert not torch.equal(other.obs[9:], data.obs[9:])
    trainee = as_leaf_params(student[0])
    agg = pt.make_aggregate_add(cfg)(pt.aggregate_init(cfg, "cpu"), data, gen)
    train_round, optim_init = pt.make_train_from_aggregate(cfg)
    _, _, losses = train_round(trainee, optim_init(trainee), agg, gen)
    assert losses.shape == (3,) and bool(torch.isfinite(losses).all())
    assert not torch.equal(trainee["dense_2"]["weights"].detach(), student[1]["dense_2"]["weights"])
    noisy = dataclasses.replace(env_params, disturbance_force_std=env_params.mass * 0 + 0.01)
    with pytest.raises(ValueError, match="deterministic-dynamics only"):
        pt.fused_collect_round(student[1], tactors, noisy, gen, env, cfg, relabel)


# ---------------------------------------------------------------------------
# BPTT loss and its gradients
# ---------------------------------------------------------------------------


def sequences(seed, t=9, b=6):
    rng = np.random.default_rng(seed)
    obs = rng.normal(0, 0.6, (t, b, 22)).astype(np.float32)
    obs[..., 11] = np.where(rng.random((t, b)) < 0.4, -0.5, 0.9)  # R22: some frames severe
    label = rng.uniform(-1, 1, (t, b, 4)).astype(np.float32)
    reset = (rng.random((t, b)) < 0.25).astype(np.float32)
    return obs, label, reset


BPTT_CASES = {
    "plain": {},
    "severe": dict(severe_weight=8.0, severe_tilt=1.2),
    "normed": dict(norm=True),
    "normed_severe": dict(norm=True, severe_weight=3.0, severe_tilt=0.3),
}


@pytest.mark.parametrize("case", list(BPTT_CASES))
def test_bptt_loss_and_gradients_match_jax(student, case):
    kwargs = dict(BPTT_CASES[case])
    obs, label, reset = sequences(0)
    jnorm = tnorm = None
    if kwargs.pop("norm", False):
        rng = np.random.default_rng(1)
        mean, std = rng.normal(0, 0.3, 22).astype(np.float32), rng.uniform(0.5, 2, 22).astype(
            np.float32)
        jnorm = {"mean": jnp.asarray(mean), "std": jnp.asarray(std)}
        tnorm = {"mean": torch.from_numpy(mean), "std": torch.from_numpy(std)}
    jparams = jax.tree.map(jnp.asarray, student[0])
    # h0 = 0 at init would hide an error in its gradient path: move it
    jparams["gru_1"]["initial_hidden_state"] = jnp.linspace(-0.3, 0.3, 16)
    want_actions = jpt.bptt_actions(jparams, jnp.asarray(obs), jnp.asarray(reset), jnorm)
    want_loss, want_grads = jax.value_and_grad(jpt.bptt_loss)(
        jparams, jnp.asarray(obs), jnp.asarray(label), jnp.asarray(reset), jnorm, **kwargs)
    tparams = as_leaf_params(to_np(jparams))
    got_actions = pt.bptt_actions(tparams, torch.from_numpy(obs), torch.from_numpy(reset), tnorm)
    np.testing.assert_allclose(got_actions.detach().numpy(), np.asarray(want_actions), atol=1e-5)
    loss = pt.bptt_loss(tparams, torch.from_numpy(obs), torch.from_numpy(label),
                        torch.from_numpy(reset), tnorm, **kwargs)
    assert abs(float(loss) - float(want_loss)) < 1e-5
    loss.backward()
    for layer, name in leaves(tparams):
        want = np.asarray(want_grads[layer][name])
        got = tparams[layer][name].grad.numpy()
        assert np.abs(want).max() > 1e-4, (layer, name)  # every leaf gets a gradient
        np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(), rtol=0,
                                   err_msg=f"{layer}/{name}")


def test_bptt_reset_masking_and_severe_mask(student):
    obs, label, _ = sequences(2, t=5, b=3)
    obs_t, label_t = torch.from_numpy(obs), torch.from_numpy(label)
    ones, zeros = torch.ones(5, 3), torch.zeros(5, 3)
    # reset everywhere: every step starts from the learned initial state
    h0 = student_net.initial_hidden(student[1], 3)
    per_step = torch.stack([student_net.apply_step(student[1], h0, obs_t[t])[1] for t in range(5)])
    np.testing.assert_allclose(pt.bptt_actions(student[1], obs_t, ones).numpy(), per_step.numpy(),
                               atol=1e-6)
    # no reset: the hidden state is carried, as apply_sequence carries it
    np.testing.assert_allclose(pt.bptt_actions(student[1], obs_t, zeros).numpy(),
                               student_net.apply_sequence(student[1], obs_t)[1].numpy(), atol=1e-6)
    # reset[t] acts on row t + 1, and only on its own column
    one = zeros.clone()
    one[1, 2] = 1.0
    mixed = pt.bptt_actions(student[1], obs_t, one)
    carried = pt.bptt_actions(student[1], obs_t, zeros)
    assert torch.equal(mixed[:2], carried[:2]) and torch.equal(mixed[:, :2], carried[:, :2])
    assert torch.equal(mixed[2, 2], per_step[2, 2]) and not torch.equal(mixed[2, 2], carried[2, 2])
    np.testing.assert_array_equal(pt.severe_mask(obs_t, 1.2).numpy(),
                                  np.asarray(jpt.severe_mask(jnp.asarray(obs), 1.2)))
    assert float(pt.bptt_loss(student[1], obs_t, label_t, ones)) == float(
        pt.bptt_loss(student[1], obs_t, label_t, ones, severe_weight=1.0, severe_tilt=1.2))


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cfg_kwargs", [
    dict(total_grad_steps=200),
    dict(total_grad_steps=200, lr_warmup_frac=0.1, lr_final_scale=0.2, learning_rate=3e-4),
    dict(total_grad_steps=20),  # warmup = max(1, int(0.4)) = 1 step
    dict(total_grad_steps=0),
])
def test_lr_schedule_matches_optax_at_every_step(cfg_kwargs):
    cfg = pt.DistillConfig(**cfg_kwargs)
    schedule = pt.lr_schedule(cfg)
    if cfg.total_grad_steps > 0:
        want = optax.warmup_cosine_decay_schedule(
            init_value=cfg.learning_rate * 0.1, peak_value=cfg.learning_rate,
            warmup_steps=max(1, int(cfg.total_grad_steps * cfg.lr_warmup_frac)),
            decay_steps=cfg.total_grad_steps, end_value=cfg.learning_rate * cfg.lr_final_scale)
    else:
        want = lambda count: cfg.learning_rate  # noqa: E731
    horizon = max(cfg.total_grad_steps, 20) + 10  # and flat past the end
    for count in range(horizon):
        assert abs(schedule(count) - float(want(count))) < 1e-7, count
    if cfg.total_grad_steps > 0:
        assert abs(schedule(0) - 0.1 * cfg.learning_rate) < 1e-12
        assert abs(schedule(horizon) - cfg.lr_final_scale * cfg.learning_rate) < 1e-12


@pytest.mark.parametrize("scheduled", [False, True])
def test_three_adam_steps_match_optax(student, scheduled):
    kwargs = dict(total_grad_steps=50, severe_weight=2.0) if scheduled else {}
    jcfg, tcfg = jpt.DistillConfig(**kwargs), pt.DistillConfig(**kwargs)
    optim = jpt.make_optimizer(jcfg)
    jparams = jax.tree.map(jnp.asarray, student[0])
    opt_state = optim.init(jparams)
    tparams = as_leaf_params(student[0])
    opt = pt.make_optimizer(tcfg)(tparams)
    for step in range(3):
        obs, label, reset = sequences(10 + step)
        jloss, grads = jax.value_and_grad(jpt.bptt_loss)(
            jparams, jnp.asarray(obs), jnp.asarray(label), jnp.asarray(reset), None,
            jcfg.severe_weight, jcfg.severe_tilt)
        updates, opt_state = optim.update(grads, opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        tloss = pt._grad_step(tparams, opt, *pt._loss_and_grad(
            tparams, torch.from_numpy(obs), torch.from_numpy(label), torch.from_numpy(reset),
            None, tcfg))
        assert abs(float(tloss) - float(jloss)) < 1e-5
    assert opt[1].last_epoch == 3
    moved = 0.0
    for layer, name in leaves(tparams):
        got = tparams[layer][name].detach().numpy()
        np.testing.assert_allclose(got, np.asarray(jparams[layer][name]), atol=1e-5, rtol=0,
                                   err_msg=f"{layer}/{name}")
        assert tparams[layer][name].grad is None  # cleared after the step
        moved = max(moved, float(np.abs(got - student[0][layer][name]).max()))
    assert moved > (2e-4 if scheduled else 2e-3)  # about 3 steps of the learning rate


# ---------------------------------------------------------------------------
# aggregate, normalizer
# ---------------------------------------------------------------------------


def test_aggregate_appends_then_replaces_distinct_columns():
    cfg = pt.DistillConfig(rollout_length=6, aggregate_capacity=10, grad_steps_per_round=2,
                           batch_size=4)
    agg = pt.aggregate_init(cfg, "cpu")
    jagg = jpt.aggregate_init(jpt.DistillConfig(rollout_length=6, aggregate_capacity=10))
    assert agg.obs.dtype == agg.teacher_action.dtype == agg.reset.dtype == torch.bfloat16
    assert agg.obs.shape == jagg.obs.shape and agg.teacher_action.shape == jagg.teacher_action.shape
    add = pt.make_aggregate_add(cfg)
    gen = torch.Generator().manual_seed(0)

    def round_data(val, b):
        obs = torch.full((6, b, 22), val) + torch.arange(b)[None, :, None] / 16.0
        return pt.RoundData(obs=obs, teacher_action=torch.full((6, b, 4), val),
                            reset=(torch.arange(6)[:, None] + torch.arange(b)[None] == 3).float())

    agg = add(agg, round_data(1.0, 4), gen)
    assert agg.size == 4
    agg = add(agg, round_data(2.0, 4), gen)
    assert agg.size == 8
    first = agg.obs[0, :, 0].float().numpy()
    np.testing.assert_array_equal(first[:8], np.concatenate([1 + np.arange(4) / 16,
                                                             2 + np.arange(4) / 16]))
    assert np.all(first[8:] == 0.0)
    np.testing.assert_array_equal(agg.reset[:, :4].float().numpy(),
                                  round_data(1.0, 4).reset.numpy())  # 0/1 exact in bf16
    # the crossing round fills the last two columns and replaces two others
    agg = add(agg, round_data(3.0, 4), gen)
    assert agg.size == 10
    # full: a round replaces exactly b distinct columns, none of its sequences is dropped
    for val in (4.0, 5.0, 6.0):
        agg = add(agg, round_data(val, 4), gen)
        first = agg.obs[0, :, 0].float().numpy()
        np.testing.assert_array_equal(np.sort(first[(first >= val) & (first < val + 1)]),
                                      val + np.arange(4) / 16)
    assert agg.size == 10
    # storage is bf16: values round to 8 bits of mantissa
    wide = pt.RoundData(obs=torch.full((6, 1, 22), 1.00390625), teacher_action=torch.zeros(6, 1, 4),
                        reset=torch.zeros(6, 1))
    agg2 = add(pt.aggregate_init(cfg, "cpu"), wide, gen)
    assert float(agg2.obs[0, 0, 0]) == 1.0
    with pytest.raises(ValueError, match="exceeds aggregate capacity"):
        add(agg, round_data(7.0, 11), gen)


def test_fit_norm_matches_jax_and_folds_exactly(student):
    rng = np.random.default_rng(3)
    obs = (rng.normal(0, 1, (9, 12, 22)) * rng.uniform(0.3, 3, 22) + rng.normal(0, 1, 22)).astype(
        np.float32)
    obs[..., 18:22] = 0.0  # a constant channel: the std floor holds its scale
    jn, tn = jpt.fit_norm(jnp.asarray(obs)), pt.fit_norm(torch.from_numpy(obs))
    for name in ("mean", "std"):
        np.testing.assert_allclose(tn[name].numpy(), np.asarray(jn[name]), atol=1e-6, rtol=1e-6)
    assert float(tn["std"][18]) == pytest.approx(1e-2)
    ident = pt.identity_norm("cpu")
    assert torch.equal(pt._norm_obs(torch.from_numpy(obs), ident), torch.from_numpy(obs))
    assert pt._norm_obs(torch.from_numpy(obs), None) is not None
    # fold_norm(params)(raw obs) == params(normalized obs)
    x = torch.from_numpy(obs[0])
    h = student_net.initial_hidden(student[1], 12)
    h_a, a_a = student_net.apply_step(student[1], h, pt._norm_obs(x, tn))
    h_b, a_b = student_net.apply_step(
        student_net.fold_norm(student[1], tn["mean"], tn["std"]), h, x)
    np.testing.assert_allclose(a_a.numpy(), a_b.numpy(), atol=1e-5)
    np.testing.assert_allclose(h_a.numpy(), h_b.numpy(), atol=1e-5)
    jfolded = jstudent_net.fold_norm(jax.tree.map(jnp.asarray, student[0]), jn["mean"], jn["std"])
    tfolded = student_net.fold_norm(student[1], tn["mean"], tn["std"])
    for name in ("weights", "biases"):
        np.testing.assert_allclose(tfolded["dense_0"][name].numpy(),
                                   np.asarray(jfolded["dense_0"][name]), atol=1e-4, rtol=1e-5)


# ---------------------------------------------------------------------------
# the round loop
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def short_env():
    return L2F(EnvConfig(episode_length=30))


def probe_loss(env, teachers, student_params, m=4, t=30):
    """Loss on held-out pure-teacher rollouts (beta = 1)."""
    _, _, tactors, tframes = teachers
    cfg = pt.DistillConfig(envs_per_teacher=m, rollout_length=t)
    probe = pt.make_collect(env, cfg)(
        student_params, tactors, population.broadcast_airframe_to_envs(tframes, m),
        torch.Generator().manual_seed(99), 1.0)
    return lambda p: float(pt.bptt_loss(p, probe.obs, probe.teacher_action, probe.reset))


def test_distill_reduces_loss_with_the_epoch_trainer(teachers, short_env):
    _, _, tactors, tframes = teachers
    cfg = pt.DistillConfig(envs_per_teacher=4, rollout_length=30, epochs_per_round=2,
                           batch_size=4, teacher_mix_decay_rounds=2)
    logged = []
    student, history = pt.distill(
        torch.Generator().manual_seed(2), short_env, tactors, tframes, cfg, n_rounds=4,
        log_fn=lambda tag, v, s: logged.append((tag, v, s)))
    assert len(history) == 8  # 4 rounds x 2 epochs
    assert np.all(np.isfinite(history))
    assert history[-1] < history[0] * 0.8, history
    losses = [v for tag, v, _ in logged if tag == "loss"]
    assert len(losses) == 4 * 2 * 4  # rounds x epochs x (16 sequences / 4 per batch)
    assert {tag for tag, _, _ in logged} == {"loss", "seconds/collect", "seconds/train"}
    assert all(not t.requires_grad for layer in student.values() for t in layer.values())


def test_distill_reduces_loss_with_the_aggregate_trainer(teachers, short_env):
    _, _, tactors, tframes = teachers
    cfg = pt.DistillConfig(envs_per_teacher=4, rollout_length=30, batch_size=8,
                           teacher_mix_decay_rounds=2, aggregate_capacity=48,
                           grad_steps_per_round=16, total_grad_steps=64)
    student0 = student_net.init_params(torch.Generator().manual_seed(2))
    probe = probe_loss(short_env, teachers, student0)
    steps_seen, tags = [], set()
    student, history = pt.distill(
        torch.Generator().manual_seed(2), short_env, tactors, tframes, cfg, n_rounds=4,
        log_fn=lambda tag, v, s: (steps_seen.append(s), tags.add(tag)))
    assert len(history) == 4 and np.all(np.isfinite(history))  # one entry per round
    assert probe(student) < probe(student0) * 0.5, (probe(student0), probe(student))
    assert max(s for s in steps_seen) >= 48  # the gradient-step counter spans rounds
    assert {"loss", "gradient_steps", "seconds/collect", "seconds/aggregate_add",
            "seconds/train"} <= tags


def test_distill_teachers_per_round(teachers, short_env):
    _, _, tactors, tframes = teachers
    k_sub, m, t = 2, 4, 20
    cfg = pt.DistillConfig(envs_per_teacher=m, rollout_length=t, teacher_mix_decay_rounds=2,
                           aggregate_capacity=32, grad_steps_per_round=3, batch_size=8,
                           teachers_per_round=k_sub)
    seen = []
    _, history = pt.distill(torch.Generator().manual_seed(2), short_env, tactors, tframes, cfg,
                            n_rounds=3, round_hook=lambda r, s, steps: seen.append(steps))
    assert seen == [t * k_sub * m * (i + 1) for i in range(3)]
    assert np.all(np.isfinite(history))


def test_distill_standardize_and_diagnostics(teachers, short_env):
    _, _, tactors, tframes = teachers
    cfg = pt.DistillConfig(envs_per_teacher=4, rollout_length=30, batch_size=8,
                           teacher_mix_decay_rounds=2, aggregate_capacity=48,
                           grad_steps_per_round=16, total_grad_steps=64, standardize=True,
                           diagnostics=True)
    student0 = student_net.init_params(torch.Generator().manual_seed(2))
    probe = probe_loss(short_env, teachers, student0)  # raw observations, no normalizer
    tags, hooked = {}, []
    student, history = pt.distill(
        torch.Generator().manual_seed(2), short_env, tactors, tframes, cfg, n_rounds=4,
        log_fn=lambda tag, v, s: tags.setdefault(tag, []).append(v),
        round_hook=lambda r, s, steps: hooked.append(s))
    assert np.all(np.isfinite(history))
    for tag in ("loss_fresh", "mse_dim0", "mse_dim3", "teacher_disagreement", "severe_frac",
                "severe_frac_probe", "loss_severe", "loss_hover"):
        values = tags[f"diagnostics/{tag}"]
        assert len(values) == 4 and np.all(np.isfinite(values)), tag
    # the returned student is a plain folded policy
    assert probe(student) < probe(student0) * 0.5, (probe(student0), probe(student))
    assert len(hooked) == 4
    assert not torch.equal(hooked[0]["dense_0"]["weights"], student0["dense_0"]["weights"])


def test_diagnostics_recombine(teachers, short_env, student):
    _, _, tactors, tframes = teachers
    m = 4
    data = pt.make_collect(short_env, pt.DistillConfig(envs_per_teacher=m, rollout_length=25))(
        student[1], tactors, population.broadcast_airframe_to_envs(tframes, m),
        torch.Generator().manual_seed(3), 1.0)
    fresh, disagree = pt.make_diagnostics(short_env, probe_cols=K * m, severe_tilt=1.0)
    out = fresh(student[1], data)
    direct = float(pt.severe_mask(data.obs, 1.0).float().mean())
    assert abs(float(out["severe_frac"]) - direct) < 1e-6
    sev = float(out["severe_frac_probe"])
    recombined = sev * float(out["loss_severe"]) + (1 - sev) * float(out["loss_hover"])
    assert abs(recombined - float(out["loss_fresh"])) < 1e-5
    assert abs(float(out["mse_dim"].mean()) - float(out["loss_fresh"])) < 1e-6
    # disagreement against the JAX probe on handed-across data
    jactors, jframes, _, _ = teachers
    jfresh, jdisagree = jpt.make_diagnostics(JL2F(), probe_cols=K * m, severe_tilt=1.0)
    want = float(jdisagree(jactors, jframes, jnp.asarray(data.obs.numpy())))
    assert abs(float(disagree(tactors, tframes, data.obs)) - want) < 1e-6
    jout = jfresh(jax.tree.map(jnp.asarray, student[0]),
                  jpt.RoundData(*(jnp.asarray(x.numpy()) for x in data)))
    for tag in ("loss_fresh", "severe_frac", "severe_frac_probe", "loss_severe", "loss_hover"):
        assert abs(float(out[tag]) - float(jout[tag])) < 1e-5, tag


def test_distill_student_hidden_ablation(teachers, short_env):
    _, _, tactors, tframes = teachers
    cfg = pt.DistillConfig(envs_per_teacher=2, rollout_length=20, epochs_per_round=1,
                           batch_size=4, teacher_mix_decay_rounds=1, student_hidden=8)
    student, history = pt.distill(torch.Generator().manual_seed(2), short_env, tactors, tframes,
                                  cfg, n_rounds=2)
    assert student["dense_0"]["weights"].shape == (8, 22)
    assert student["gru_1"]["weights_input"].shape == (24, 8)
    assert student["gru_1"]["initial_hidden_state"].shape == (8,)
    assert student["dense_2"]["weights"].shape == (4, 8)
    assert np.all(np.isfinite(history))
    h, act = student_net.apply_step(student, student_net.initial_hidden(student, 3),
                                    torch.zeros(3, 22))
    assert act.shape == (3, 4) and h.shape == (3, 8)


def test_demo_rollout_frac_drives_expert_envs(teachers, short_env, student):
    _, _, tactors, tframes = teachers
    m = 4
    env_params = population.broadcast_airframe_to_envs(tframes, m)
    base = dict(envs_per_teacher=m, rollout_length=25, demo_tilt=1.2)
    runs = [
        pt.make_collect(short_env, pt.DistillConfig(**base, **extra))(
            student[1], tactors, env_params, torch.Generator().manual_seed(3), 0.0)
        for extra in ({}, dict(demo_rollout_frac=0.5))
    ]
    o0, o1 = runs[0].obs.numpy(), runs[1].obs.numpy()
    demo_cols = [k * m + j for k in range(K) for j in range(2)]
    other_cols = [k * m + j for k in range(K) for j in range(2, m)]
    assert not np.allclose(o0[:, demo_cols], o1[:, demo_cols])
    np.testing.assert_array_equal(o0[:, other_cols], o1[:, other_cols])
    assert np.all(np.isfinite(o1)) and bool(torch.isfinite(runs[1].teacher_action).all())
    cfg = pt.DistillConfig(**{**base, "rollout_length": 20}, demo_rollout_frac=0.5, demo_rate=5.0,
                           demo_adaptive=True, aggregate_capacity=32, grad_steps_per_round=2,
                           batch_size=4)
    _, history = pt.distill(torch.Generator().manual_seed(2), short_env, tactors, tframes, cfg,
                            n_rounds=2)
    assert np.all(np.isfinite(history))


def test_tree_map_take_subsamples_actors_and_airframes_alike(teachers):
    _, _, tactors, tframes = teachers
    idx = torch.tensor([2, 0])
    sub_a = networks.take_actors(tactors, idx)
    sub_f = tree_map(lambda x: x[idx], tframes)
    assert networks.n_actors(sub_a) == 2 and sub_f.mass.shape == (2,)
    assert torch.equal(sub_f.mass, tframes.mass[idx])
    assert torch.equal(sub_a["layers"][1]["b"], tactors["layers"][1]["b"][idx])
