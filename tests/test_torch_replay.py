"""The port's replay ring (`raptor_tpu_torch/rl/replay.py`) against the JAX
package's `TransitionBuffer`: writes, wrap-around, pointer and size, and both
samplers on indices recomputed in JAX from the same key. Everything here is a
copy or a gather, so every comparison is exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raptor_tpu.rl import replay as jreplay
from raptor_tpu_torch.checkpoint import transition_buffer_from_numpy
from raptor_tpu_torch.rl import replay

C, N, OBS, ACT = 12, 4, 7, 3
FIELDS = ("obs", "action", "reward", "next_obs", "done")


def rows(rng, h, lead=()):
    return (
        rng.standard_normal((*lead, h, N, OBS)).astype(np.float32),
        rng.standard_normal((*lead, h, N, ACT)).astype(np.float32),
        rng.standard_normal((*lead, h, N)).astype(np.float32),
        rng.standard_normal((*lead, h, N, OBS)).astype(np.float32),
        (rng.random((*lead, h, N)) < 0.3).astype(np.float32),
    )


def assert_same(tbuf, jbuf):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(tbuf, f).numpy(), np.asarray(getattr(jbuf, f)), f)
    assert tbuf.ptr == int(np.max(np.asarray(jbuf.ptr)))
    assert tbuf.size == int(np.max(np.asarray(jbuf.size)))


def test_add_and_add_rollout_across_the_wrap_match_jax():
    rng = np.random.default_rng(0)
    jbuf = jreplay.transition_buffer_init(C, N, OBS, ACT)
    tbuf = replay.transition_buffer_init(C, N, OBS, ACT, "cpu")
    assert tbuf.capacity == C and tbuf.n_envs == N and tbuf.lead == ()
    for h in (5, 1, 5, 4, 7):  # 5 + 1 + 5 = 11, then 4 wraps, then 7 wraps again
        r = rows(rng, h)
        if h == 1:
            jbuf = jreplay.transition_buffer_add(jbuf, *(jnp.asarray(x[0]) for x in r))
            tbuf = replay.transition_buffer_add(tbuf, *(torch.from_numpy(x[0]) for x in r))
        else:
            jbuf = jreplay.transition_buffer_add_rollout(jbuf, *(jnp.asarray(x) for x in r))
            tbuf = replay.transition_buffer_add_rollout(tbuf, *(torch.from_numpy(x) for x in r))
        assert_same(tbuf, jbuf)
    assert tbuf.size == C and tbuf.ptr == 22 % C


def test_writes_are_in_place():
    tbuf = replay.transition_buffer_init(C, N, OBS, ACT, "cpu", n_stack=2)
    before = tbuf.obs.data_ptr()
    r = rows(np.random.default_rng(1), 3, (2,))
    out = replay.transition_buffer_add_rollout(tbuf, *(torch.from_numpy(x) for x in r))
    assert out is tbuf and tbuf.obs.data_ptr() == before
    assert tbuf.obs.shape == (2, C, N, OBS) and tbuf.lead == (2,)
    np.testing.assert_array_equal(tbuf.obs[:, :3].numpy(), r[0])


def filled(k=None, n_rows=9):
    """A JAX ring (stacked over k members where given) with n_rows written,
    and the port's ring made from it."""
    rng = np.random.default_rng(2)

    def one(seed):
        r = rows(np.random.default_rng(seed), n_rows)
        return jreplay.transition_buffer_add_rollout(
            jreplay.transition_buffer_init(C, N, OBS, ACT), *(jnp.asarray(x) for x in r))

    if k is None:
        jbuf = one(int(rng.integers(1 << 30)))
    else:
        jbuf = jax.tree.map(lambda *xs: jnp.stack(xs), *[one(s) for s in range(k)])
    return jbuf, transition_buffer_from_numpy(jax.tree.map(np.asarray, jbuf), "cpu")


def test_uniform_sampler_matches_jax_on_its_indices():
    jbuf, tbuf = filled()
    key, b = jax.random.key(5), 16
    kt, ke = jax.random.split(key)  # as transition_buffer_sample splits it
    t_idx = jax.random.randint(kt, (b,), 0, jnp.maximum(jbuf.size, 1))
    e_idx = jax.random.randint(ke, (b,), 0, N)
    ref = jreplay.transition_buffer_sample(jbuf, key, b)
    got = replay.transition_buffer_sample(
        tbuf, None, b, idx=(torch.from_numpy(np.asarray(t_idx).astype(np.int64)),
                            torch.from_numpy(np.asarray(e_idx).astype(np.int64))))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_row_sampler_matches_jax_on_its_indices():
    jbuf, tbuf = filled()
    key, b = jax.random.key(6), 3 * N
    t_idx = jax.random.randint(key, (3,), 0, jnp.maximum(jbuf.size, 1))
    ref = jreplay.transition_buffer_sample_rows(jbuf, key, b)
    got = replay.transition_buffer_sample_rows(
        tbuf, None, b, idx=torch.from_numpy(np.asarray(t_idx).astype(np.int64)))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("sampler", ["uniform", "rows"])
def test_stacked_samplers_match_vmap_each_member_its_own_draw(sampler):
    k = 3
    jbuf, tbuf = filled(k)
    assert tbuf.lead == (k,) and tbuf.size == 9
    keys = jax.random.split(jax.random.key(7), k)
    if sampler == "uniform":
        b = 10
        ref = jax.vmap(lambda bf, ky: jreplay.transition_buffer_sample(bf, ky, b))(jbuf, keys)

        def draw(ky):
            kt, ke = jax.random.split(ky)
            return (jax.random.randint(kt, (b,), 0, 9), jax.random.randint(ke, (b,), 0, N))

        idx = tuple(torch.from_numpy(np.asarray(x).astype(np.int64)) for x in jax.vmap(draw)(keys))
        got = replay.transition_buffer_sample(tbuf, None, b, idx=idx)
        assert len({tuple(row) for row in idx[0].tolist()}) == k  # the members' draws differ
    else:
        b = 2 * N
        ref = jax.vmap(lambda bf, ky: jreplay.transition_buffer_sample_rows(bf, ky, b))(jbuf, keys)
        idx = jax.vmap(lambda ky: jax.random.randint(ky, (2,), 0, 9))(keys)
        got = replay.transition_buffer_sample_rows(
            tbuf, None, b, idx=torch.from_numpy(np.asarray(idx).astype(np.int64)))
    for g, r in zip(got, ref):
        assert g.shape[:2] == (k, b)
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_samplers_draw_inside_the_filled_rows():
    _, tbuf = filled(3, n_rows=5)
    gen = torch.Generator().manual_seed(0)
    # rows 5.. of the ring are still zero: no sample may come from there
    tbuf.obs[:, :5] += 100.0
    for fn, b in ((replay.transition_buffer_sample, 64),
                  (replay.transition_buffer_sample_rows, 16 * N)):
        obs, action, reward, next_obs, done = fn(tbuf, gen, b)
        assert obs.shape == (3, b, OBS) and action.shape == (3, b, ACT)
        assert reward.shape == done.shape == (3, b) and next_obs.shape == obs.shape
        assert float(obs.min()) > 50.0
    # an empty ring still samples (row 0), as in the JAX package
    empty = replay.transition_buffer_init(C, N, OBS, ACT, "cpu")
    assert float(replay.transition_buffer_sample(empty, gen, 4)[0].abs().max()) == 0.0


@pytest.mark.parametrize("batch", [N + 1, 2, 0])
def test_row_sampler_refuses_a_batch_that_is_no_multiple_of_the_envs(batch):
    jbuf, tbuf = filled()
    with pytest.raises(ValueError, match="multiple"):
        jreplay.transition_buffer_sample_rows(jbuf, jax.random.key(0), batch)
    with pytest.raises(ValueError, match="multiple"):
        replay.transition_buffer_sample_rows(tbuf, torch.Generator(), batch)
