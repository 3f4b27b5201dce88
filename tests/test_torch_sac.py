"""The teacher farm's networks and SAC learner (`raptor_tpu_torch/rl/
networks.py`, `rl/sac.py`) against the JAX package, on the CPU.

Inputs, states, batches and noise are made with numpy or JAX and handed
across as numpy arrays; the JAX side runs as its own tests run it (f32
matmuls at "highest", tests/conftest.py). Tolerances: network outputs 2e-6
(tests/test_sac_fastpath.py:78), `matmul_lp` and its gradients 1e-5 against
JAX's and the bounds of tests/test_sac_fastpath.py:40,50 against f32;
`sac_update` 1e-5 on every leaf and rtol 1e-4 on the metrics after three
updates.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raptor_tpu.rl import networks as jnetworks
from raptor_tpu.rl import sac as jsac
from raptor_tpu_torch.checkpoint import (
    critic_from_numpy, mlp_from_numpy, sac_state_from_numpy,
)
from raptor_tpu_torch.rl import networks, sac

OBS, ACT, K, B = 31, 4, 3, 16


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def t(x):
    return torch.from_numpy(np.array(x, np.float32))


def stacked(init, seed):
    """K JAX networks stacked on a leading axis."""
    return jax.vmap(init)(jax.random.split(jax.random.key(seed), K))


@pytest.mark.parametrize("stack", [False, True])
def test_sample_and_squash_and_actor_sample_match_jax(stack):
    rng = np.random.default_rng(0)
    lead = (K,) if stack else ()
    mu = rng.standard_normal((*lead, B, ACT)).astype(np.float32) * 2
    log_std = rng.uniform(-3, 1, (*lead, B, ACT)).astype(np.float32)
    key = jax.random.key(1)
    eps = np.asarray(jax.random.normal(key, mu.shape))  # what sample_and_squash draws
    ref_a, ref_lp = jnetworks.sample_and_squash(key, jnp.asarray(mu), jnp.asarray(log_std))
    got_a, got_lp = networks.sample_and_squash(t(mu), t(log_std), eps=t(eps))
    assert got_lp.shape == (*lead, B)
    np.testing.assert_allclose(got_a.numpy(), np.asarray(ref_a), atol=2e-6)
    np.testing.assert_allclose(got_lp.numpy(), np.asarray(ref_lp), atol=2e-5, rtol=1e-6)

    init = lambda k: jnetworks.actor_init(k, OBS, ACT)  # noqa: E731
    jactor = stacked(init, 2) if stack else init(jax.random.key(2))
    obs = rng.standard_normal((*lead, B, OBS)).astype(np.float32)
    sample = lambda p, o: jnetworks.actor_sample(p, key, o)  # noqa: E731
    ref_a, ref_lp = (jax.vmap(sample) if stack else sample)(jactor, jnp.asarray(obs))
    got_a, got_lp = networks.actor_sample(mlp_from_numpy(to_np(jactor), "cpu"), t(obs),
                                          eps=t(np.asarray(jax.random.normal(key, (B, ACT)))))
    np.testing.assert_allclose(got_a.numpy(), np.asarray(ref_a), atol=2e-6)
    np.testing.assert_allclose(got_lp.numpy(), np.asarray(ref_lp), atol=2e-5, rtol=1e-6)


def test_sample_and_squash_draws_from_the_generator_and_stays_finite():
    gen = torch.Generator().manual_seed(0)
    mu = torch.full((4096, ACT), 9.0)  # deep in the tanh's tail: the stable form must hold
    a, lp = networks.sample_and_squash(mu, torch.zeros_like(mu), gen)
    assert bool(torch.isfinite(lp).all()) and float(a.min()) > 0.999
    a0, _ = networks.sample_and_squash(torch.zeros(4096, ACT), torch.zeros(4096, ACT), gen)
    pre = torch.atanh(a0)
    assert abs(float(pre.mean())) < 0.05 and abs(float(pre.std()) - 1.0) < 0.05


@pytest.mark.parametrize("stack", [False, True])
@pytest.mark.parametrize("twin_stacked", [False, True])
def test_critic_apply_matches_jax(stack, twin_stacked):
    rng = np.random.default_rng(3)
    lead = (K,) if stack else ()
    init = lambda k: jnetworks.critic_init(k, OBS, ACT)  # noqa: E731
    jcritic = stacked(init, 4) if stack else init(jax.random.key(4))
    obs = rng.standard_normal((*lead, B, OBS)).astype(np.float32)
    act = np.tanh(rng.standard_normal((*lead, B, ACT))).astype(np.float32)
    apply = lambda p, o, a: jnetworks.critic_apply(p, o, a, stacked=twin_stacked)  # noqa: E731
    ref = (jax.vmap(apply) if stack else apply)(jcritic, jnp.asarray(obs), jnp.asarray(act))
    got = networks.critic_apply(critic_from_numpy(to_np(jcritic), "cpu"), t(obs), t(act),
                                stacked=twin_stacked)
    for g, r in zip(got, ref):
        assert g.shape == (*lead, B)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=2e-6)


def test_inits_have_the_jax_shapes_and_scales():
    gen = torch.Generator().manual_seed(0)
    jactor = jnetworks.actor_init(jax.random.key(0), OBS, ACT)
    jcritic = jnetworks.critic_init(jax.random.key(0), OBS, ACT)
    actor = networks.actor_init(gen, OBS, ACT, n_stack=K)
    critic = networks.critic_init(gen, OBS, ACT, n_stack=K)
    for mine, ref in ((actor, jactor), (critic["q1"], jcritic["q1"]), (critic["q2"], jcritic["q2"])):
        for lm, lr in zip(mine["layers"], ref["layers"]):
            assert lm["w"].shape == (K, *lr["w"].shape) and lm["b"].shape == (K, *lr["b"].shape)
            assert float(lm["b"].abs().max()) == 0.0
    # uniform +-1/sqrt(fan_in), and +-0.01/sqrt(fan_in) on the actor's head
    assert float(actor["layers"][0]["w"].abs().max()) <= 1 / np.sqrt(OBS)
    assert float(actor["layers"][0]["w"].abs().max()) > 0.9 / np.sqrt(OBS)
    assert float(actor["layers"][-1]["w"].abs().max()) <= 0.01 / 8
    assert not torch.equal(critic["q1"]["layers"][0]["w"], critic["q2"]["layers"][0]["w"])
    assert not torch.equal(actor["layers"][0]["w"][0], actor["layers"][0]["w"][1])


def test_matmul_lp_forward_and_gradients_match_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((32, 24)).astype(np.float32)
    w = (rng.standard_normal((24, 16)) / 5.0).astype(np.float32)

    f_lp = lambda x, w: jnp.sum(jnp.tanh(jnetworks.matmul_lp(jnp.bfloat16, x, w)))  # noqa: E731
    ref_y = jnetworks.matmul_lp(jnp.bfloat16, jnp.asarray(x), jnp.asarray(w))
    ref_gx, ref_gw = jax.grad(f_lp, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))

    tx, tw = t(x).requires_grad_(True), t(w).requires_grad_(True)
    y = networks.matmul_lp(torch.bfloat16, tx, tw)
    assert y.dtype == torch.float32  # f32 out of bf16-rounded operands, not bf16
    torch.tanh(y).sum().backward()
    assert tx.grad.dtype == torch.float32 and tw.grad.dtype == torch.float32
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(ref_y), atol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(ref_gx), atol=1e-5)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(ref_gw), atol=1e-5)

    # against full f32: the bounds of the JAX package's own test
    y_ref = x @ w
    assert 0 < float(np.max(np.abs(y.detach().numpy() - y_ref))) < 0.15
    gx32, gw32 = jax.grad(lambda x, w: jnp.sum(jnp.tanh(x @ w)), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(w))
    for g_lp, g_ref in ((tx.grad.numpy(), np.asarray(gx32)), (tw.grad.numpy(), np.asarray(gw32))):
        assert np.max(np.abs(g_lp - g_ref)) / (np.max(np.abs(g_ref)) + 1e-9) < 0.05


def test_matmul_lp_batched_matches_vmap():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((K, 8, 6)).astype(np.float32)
    w = rng.standard_normal((K, 6, 4)).astype(np.float32)
    lp = lambda a, b: jnetworks.matmul_lp(jnp.bfloat16, a, b)  # noqa: E731
    ref = jax.vmap(lp)(jnp.asarray(x), jnp.asarray(w))
    ref_gw = jax.grad(lambda w: jnp.sum(jnp.sin(jax.vmap(lp)(jnp.asarray(x), w))))(jnp.asarray(w))
    tw = t(w).requires_grad_(True)
    y = networks.matmul_lp(torch.bfloat16, t(x), tw)
    torch.sin(y).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(ref), atol=1e-5)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(ref_gw), atol=1e-5)


@pytest.mark.parametrize("stack", [False, True])
def test_mlp_apply_bf16_matches_jax(stack):
    rng = np.random.default_rng(7)
    lead = (K,) if stack else ()
    init = lambda k: jnetworks.actor_init(k, OBS, ACT)  # noqa: E731
    jactor = stacked(init, 8) if stack else init(jax.random.key(8))
    obs = rng.standard_normal((*lead, B, OBS)).astype(np.float32)
    dist = lambda p, o: jnetworks.actor_dist(p, o, dtype=jnp.bfloat16)  # noqa: E731
    ref_mu, ref_ls = (jax.vmap(dist) if stack else dist)(jactor, jnp.asarray(obs))
    mu, ls = networks.actor_dist(mlp_from_numpy(to_np(jactor), "cpu"), t(obs),
                                 dtype=torch.bfloat16)
    np.testing.assert_allclose(mu.numpy(), np.asarray(ref_mu), atol=1e-5)
    np.testing.assert_allclose(ls.numpy(), np.asarray(ref_ls), atol=1e-5)


# ---------------------------------------------------------------------------
# sac_update
# ---------------------------------------------------------------------------


def config_fields_equal():
    import dataclasses

    j, p = jsac.SACConfig(), sac.SACConfig()
    return {f.name: getattr(j, f.name) for f in dataclasses.fields(j)} == \
        {f.name: getattr(p, f.name) for f in dataclasses.fields(p)}


def test_config_equals_jax_field_by_field():
    assert config_fields_equal()
    assert sac.SACConfig(compute_dtype="bfloat16")._dtype is torch.bfloat16
    assert sac.SACConfig()._dtype is None


def batch_np(rng, lead):
    return (
        rng.standard_normal((*lead, B, OBS)).astype(np.float32),
        np.tanh(rng.standard_normal((*lead, B, ACT))).astype(np.float32),
        rng.standard_normal((*lead, B)).astype(np.float32),
        rng.standard_normal((*lead, B, OBS)).astype(np.float32),
        (rng.random((*lead, B)) < 0.2).astype(np.float32),
    )


def jax_noise(key):
    """The noise sac_update draws from its key: k_next, k_pi = split(key)."""
    k_next, k_pi = jax.random.split(key)
    return jax.random.normal(k_next, (B, ACT)), jax.random.normal(k_pi, (B, ACT))


def run_both(stack, n_updates=3, jax_flags=None, port_flags=None):
    """n_updates of both learners from one handed-across state, on the same
    batches and noise. Returns (jax state, port state, metrics of both)."""
    jcfg, tcfg = jsac.SACConfig(**(jax_flags or {})), sac.SACConfig(**(port_flags or {}))
    rng = np.random.default_rng(11)
    lead = (K,) if stack else ()
    init = lambda k: jsac.sac_init(k, OBS, ACT, jcfg)  # noqa: E731
    jstate = stacked(init, 12) if stack else init(jax.random.key(12))
    tstate = sac_state_from_numpy(to_np(jstate), "cpu", tcfg)
    update = lambda s, k, b: jsac.sac_update(s, k, b, jcfg)  # noqa: E731
    if stack:
        update = jax.vmap(update)
    for i in range(n_updates):
        batch = batch_np(rng, lead)
        key = jax.random.key(100 + i)
        keys = jax.random.split(key, K) if stack else key
        noise = jax.vmap(jax_noise)(keys) if stack else jax_noise(keys)
        jstate, jm = update(jstate, keys, tuple(jnp.asarray(b) for b in batch))
        tstate, tm = sac.sac_update(tstate, None, tuple(t(b) for b in batch), tcfg,
                                    noise=tuple(t(np.asarray(n)) for n in noise))
    return jstate, tstate, jm, tm


def assert_states_close(jstate, tstate, atol=1e-5):
    ref = to_np(jstate)
    pairs = [(tstate.actor, mlp_from_numpy(ref.actor, "cpu")),
             (tstate.critic, critic_from_numpy(ref.critic, "cpu")),
             (tstate.target_critic, critic_from_numpy(ref.target_critic, "cpu"))]
    for mine, theirs in pairs:
        for a, b in zip(networks.tree_leaves(mine), networks.tree_leaves(theirs)):
            np.testing.assert_allclose(a.detach().numpy(), b.numpy(), atol=atol, rtol=0)
    np.testing.assert_allclose(tstate.log_alpha.detach().numpy(), ref.log_alpha, atol=atol)
    assert tstate.step == int(np.max(ref.step))


@pytest.mark.parametrize("stack", [False, True])
def test_three_sac_updates_match_jax(stack):
    jstate, tstate, jm, tm = run_both(stack)
    assert_states_close(jstate, tstate)
    for name in jm._fields:
        got = getattr(tm, name).numpy()
        assert got.shape == ((K,) if stack else ())
        np.testing.assert_allclose(got, np.asarray(getattr(jm, name)), rtol=1e-4, atol=1e-6,
                                   err_msg=name)
    # alpha in the metrics is the updated one
    np.testing.assert_allclose(tm.alpha.numpy(), np.exp(tstate.log_alpha.detach().numpy()))
    # the Adam moments followed too
    ref_mu = mlp_from_numpy(to_np(jstate.actor_opt[0].mu), "cpu")
    for leaf, mu in zip(networks.tree_leaves(tstate.actor), networks.tree_leaves(ref_mu)):
        st = tstate.actor_opt.state[leaf]
        np.testing.assert_allclose(st["exp_avg"].numpy(), mu.numpy(), atol=1e-6)
        assert float(st["step"]) == 3.0


@pytest.mark.parametrize("flags", [dict(stack_critics=True), dict(flat_optim=True),
                                   dict(stack_critics=True, flat_optim=True)])
def test_stack_critics_and_flat_optim_give_the_default_result(flags):
    """Against the JAX default configuration: the flags change the schedule
    of the arithmetic, not its result."""
    jstate, tstate, jm, tm = run_both(True, port_flags=flags)
    assert_states_close(jstate, tstate)
    np.testing.assert_allclose(tm.critic_loss.numpy(), np.asarray(jm.critic_loss), rtol=1e-4)


def test_bf16_update_matches_jax():
    jstate, tstate, jm, tm = run_both(
        False, jax_flags=dict(compute_dtype="bfloat16"), port_flags=dict(compute_dtype="bfloat16"))
    # a bf16 rounding that flips on a 1e-7 difference moves a weight by about 1e-4
    assert_states_close(jstate, tstate, atol=5e-4)
    np.testing.assert_allclose(tm.critic_loss.numpy(), np.asarray(jm.critic_loss), rtol=1e-2)


def test_stacked_update_is_k_independent_updates():
    """The sum-of-means loss and one Adam over stacked tensors: member k of a
    stacked update equals the single update of member k alone."""
    rng = np.random.default_rng(13)
    jstack = stacked(lambda k: jsac.sac_init(k, OBS, ACT), 14)
    batch = batch_np(rng, (K,))
    noise = tuple(rng.standard_normal((K, B, ACT)).astype(np.float32) for _ in range(2))
    whole = sac_state_from_numpy(to_np(jstack), "cpu")
    for _ in range(2):
        whole, wm = sac.sac_update(whole, None, tuple(t(b) for b in batch),
                                   noise=tuple(t(n) for n in noise))
    for k in range(K):
        one = sac_state_from_numpy(to_np(jax.tree.map(lambda x: x[k], jstack)), "cpu")
        for _ in range(2):
            one, om = sac.sac_update(one, None, tuple(t(b[k]) for b in batch),
                                     noise=tuple(t(n[k]) for n in noise))
        for a, b in zip(networks.tree_leaves(whole.critic), networks.tree_leaves(one.critic)):
            np.testing.assert_allclose(a[k].detach().numpy(), b.detach().numpy(), atol=1e-6)
        for a, b in zip(networks.tree_leaves(whole.actor), networks.tree_leaves(one.actor)):
            np.testing.assert_allclose(a[k].detach().numpy(), b.detach().numpy(), atol=1e-6)
        np.testing.assert_allclose(float(wm.actor_loss[k]), float(om.actor_loss), rtol=1e-5)


def test_actor_update_leaves_no_gradient_in_the_critic_and_targets_lag():
    gen = torch.Generator().manual_seed(0)
    state = sac.sac_init(gen, OBS, ACT, n_stack=K)
    before = [x.clone() for x in networks.tree_leaves(state.target_critic)]
    critic0 = [x.detach().clone() for x in networks.tree_leaves(state.critic)]
    assert state.log_alpha.shape == (K,)
    np.testing.assert_allclose(state.log_alpha.detach().numpy(), np.log(0.2), rtol=1e-6)
    state, m = sac.sac_update(state, gen, tuple(t(b) for b in batch_np(np.random.default_rng(0), (K,))))
    for leaf in (*networks.tree_leaves(state.critic), *networks.tree_leaves(state.actor),
                 state.log_alpha):
        assert leaf.grad is None and leaf.requires_grad
    for tgt, old, c_old, c_new in zip(networks.tree_leaves(state.target_critic), before, critic0,
                                      networks.tree_leaves(state.critic)):
        assert not tgt.requires_grad
        # polyak: 0.995 of the old target (= old critic) + 0.005 of the new critic
        np.testing.assert_allclose(tgt.numpy(), 0.995 * old.numpy() + 0.005 * c_new.detach().numpy(),
                                   atol=1e-7)
        assert not torch.equal(c_old, c_new.detach())
    assert state.step == 1 and m.critic_loss.shape == (K,)


@pytest.mark.parametrize("flags", [
    dict(compute_dtype="bfloat16"),
    dict(compute_dtype="bfloat16", stack_critics=True, flat_optim=True),
])
def test_bf16_sac_learns_on_a_fixed_batch(flags):
    """The counterpart of tests/test_sac_fastpath.py::test_bf16_sac_learns_synthetic."""
    cfg = sac.SACConfig(**flags)
    gen = torch.Generator().manual_seed(10)
    state = sac.sac_init(gen, 9, 4, cfg)
    rng = np.random.default_rng(11)
    batch = (t(rng.standard_normal((128, 9))), t(np.tanh(rng.standard_normal((128, 4)))),
             t(rng.standard_normal(128)), t(rng.standard_normal((128, 9))),
             t(rng.random(128) < 0.1))
    _, m0 = sac.sac_update(sac.sac_init(torch.Generator().manual_seed(10), 9, 4, cfg), gen,
                           batch, cfg)
    for _ in range(60):
        state, m = sac.sac_update(state, gen, batch, cfg)
    assert float(m.critic_loss) < float(m0.critic_loss)
    for leaf in (*networks.tree_leaves(state.actor), *networks.tree_leaves(state.critic)):
        assert bool(torch.isfinite(leaf).all()) and leaf.dtype == torch.float32
