"""Distillation over several devices and the multi-device dry run
(`parallel/dryrun.py`), on the CPU, held to the JAX package.

A 2-process gloo run (this file run as a script, once per rank) on the
('pop', 'env') mesh of two devices, (1, 2), from inputs JAX made or numpy
drew from a seed and handed to both sides, and a second one on the layout
with two 'pop' blocks, (2, 1), for the collect, the subsample and the
aggregate:
- each rank collects its block of the K = 4 teachers x M = 4 envs
  (`parallel.mesh.distill_block`) with `make_collect`; gathered in block
  order, the rounds at beta 0 and 1, and with demonstrator-driven envs,
  equal JAX's `make_collect` over all K x M envs from the same initial
  states (atol 2e-4, the JAX package's own tolerance for its collect);
- one round's teacher subsample is the same on both ranks, and each rank's
  block is its 'pop' block of JAX's `take` of those teachers, with its
  'env' block of their envs;
- before the aggregate is full, the union of the ranks' column blocks is the
  set of JAX's aggregate columns after the same rounds, bit for bit;
- one training step, each rank on its half of handed-across minibatch
  columns with its gradients averaged over the group, equals JAX's
  `value_and_grad(bptt_loss)` on the whole minibatch (1e-5 relative to the
  largest entry of each leaf, as `tests/test_torch_distill.py` holds the
  gradients) and one `optax.adam` step (1e-5); the ranks' students are equal
  bit for bit;
- B3's plain version over the two ranks with `env_offset` equals one process
  over all rows bit for bit.
Beside it: `dryrun_multichip(2, platform="cpu")` finishes finite, and the
layout helpers raise ValueError where a batch or a round's teachers do not
split.
"""

import argparse
import dataclasses
import os
import subprocess
import sys
from collections import Counter

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:  # run as a script (a worker), the package lies one up
    sys.path.insert(0, ROOT)

from raptor_tpu_torch.checkpoint import (  # noqa: E402
    dynamics_params_from_numpy, from_numpy, state_from_numpy, teachers_from_numpy)
from raptor_tpu_torch.distill import population  # noqa: E402
from raptor_tpu_torch.distill import post_training as pt  # noqa: E402
from raptor_tpu_torch.env import EnvConfig, InitConfig, L2F, TerminationConfig  # noqa: E402

LAYOUTS = {"1x2": (1, 2), "2x1": (2, 1)}  # ('pop', 'env') shapes of the two runs

K, M, T = 4, 4, 12
GENTLE = dict(max_angle=0.2, linear_velocity_std=0.02, angular_velocity_std=0.02)
WIDE = dict(position_bound=50.0, angular_velocity_bound=1000.0)
CASES = {"beta0": (0.0, {}), "beta1": (1.0, {}),
         "demo": (0.0, dict(demo_tilt=0.1, demo_rollout_frac=0.5))}
AGG_CAPACITY = 2 * K * M  # two rounds fill it exactly
B_TRAIN, T_TRAIN = 8, 9
TRAIN_CFG = dict(total_grad_steps=50, severe_weight=2.0)
B3_ROWS, B3_STEPS = 96, 12  # rows a rank; episodes of 5 steps, so the PRNG's env ids matter
STATE_FIELDS = ("position", "orientation", "linear_velocity", "angular_velocity", "rpm")


class HandedL2F(L2F):
    """The port's env with initial states handed across, not sampled."""

    def __init__(self, config, states):
        super().__init__(config)
        self._states = states

    def sample_state(self, params, generator):
        return self._states


def _unpack(data, prefix):
    return {k.split("/", 1)[1]: v for k, v in data.items() if k.startswith(prefix + "/")}


def _student_np(data):
    """The handed student's arrays, {layer: {name: array}}."""
    out = {}
    for key, v in data.items():
        if key.startswith("student/"):
            _, layer, name = key.split("/")
            out.setdefault(layer, {})[name] = v
    return out


def _named_leaves(student):
    return [(f"{layer}/{name}", student[layer][name]) for layer in student
            for name in student[layer]]


def worker(rank: int, port: int, inp: str, out: str, layout: str) -> None:
    """One rank of the 2-process run on the ('pop', 'env') shape `layout`
    (`LAYOUTS`); writes its results to `out`. The training step and B3 do
    not depend on the layout and run on "1x2" only."""
    import torch.distributed as dist

    from raptor_tpu_torch.ops.collect import make_fused_collect
    from raptor_tpu_torch.parallel import (
        Mesh, distill_block, gather_distill_columns, make_mesh, round_teacher_block,
        shard_distill_config)
    from raptor_tpu_torch.parallel.multihost import (
        host_generator, initialize_distributed, make_global_array)

    initialize_distributed(f"localhost:{port}", 2, rank, "cpu")
    data = dict(np.load(inp))
    shape = LAYOUTS[layout]
    mesh = Mesh(("pop", "env"), shape, divmod(rank, shape[1]))
    if layout == "1x2":
        assert mesh == make_mesh(2, ("pop", "env"))
    actors, frames = teachers_from_numpy(
        {"layers": [{"w": data[f"actor/{i}/w"], "b": data[f"actor/{i}/b"]} for i in range(3)]},
        _unpack(data, "frames"), "cpu")
    env_params = population.broadcast_airframe_to_envs(frames, M)
    student = from_numpy(_student_np(data), "cpu")

    # the block collect from handed-across initial states
    cfg_env = EnvConfig(init=InitConfig(**GENTLE), termination=TerminationConfig(**WIDE))
    states = state_from_numpy(_unpack(data, "state"), "cpu")
    p, e, n_env = mesh.index("pop"), mesh.index("env"), mesh.size("env")
    k_local, m_local = K // mesh.size("pop"), M // n_env
    block_states = type(states)(**{
        f: getattr(states, f).reshape(K, M, -1)[p * k_local:(p + 1) * k_local,
                                                e * m_local:(e + 1) * m_local].reshape(
            k_local * m_local, -1) for f in STATE_FIELDS})
    res = {"coords": np.array(mesh.coords)}
    actors_b, params_b = distill_block(actors, env_params, mesh)
    agg_cfg = shard_distill_config(
        pt.DistillConfig(envs_per_teacher=M, rollout_length=T, aggregate_capacity=AGG_CAPACITY,
                         grad_steps_per_round=1, batch_size=B_TRAIN), mesh)
    agg = pt.aggregate_init(agg_cfg, "cpu")
    add = pt.make_aggregate_add(agg_cfg)
    for case, (beta, extra) in CASES.items():
        cfg = shard_distill_config(
            pt.DistillConfig(envs_per_teacher=M, rollout_length=T, **extra), mesh)
        collect = pt.make_collect(HandedL2F(cfg_env, block_states), cfg, env_block=(e, n_env))
        round_data = collect(student, actors_b, params_b, host_generator(0), beta)
        for name in ("obs", "teacher_action", "reset"):
            res[f"collect/{case}/{name}"] = gather_distill_columns(
                getattr(round_data, name), mesh, k_local).numpy()
        if case != "demo":  # two rounds into the aggregate's blocks
            agg = add(agg, round_data, host_generator(1))
    res["agg/obs"] = agg.obs.float().numpy()
    res["agg/teacher_action"] = agg.teacher_action.float().numpy()
    res["agg/reset"] = agg.reset.float().numpy()
    res["agg/size"] = np.array(agg.size)

    # one round's teacher subsample
    idx = pt.draw_round_teachers(torch.Generator().manual_seed(11), K, 2)
    sub_actors, sub_params = round_teacher_block(actors, env_params, idx, mesh)
    res["sub/idx"] = idx.numpy()
    res["sub/w0"] = sub_actors["layers"][0]["w"].numpy()
    res["sub/mass"] = sub_params.mass.numpy()
    if layout != "1x2":
        dist.destroy_process_group()
        np.savez(out, **res)
        return

    # one training step on this rank's half of the handed minibatch columns
    leaves = _named_leaves(student)
    for _, leaf in leaves:
        leaf.requires_grad_(True)
    share = slice(rank * B_TRAIN // 2, (rank + 1) * B_TRAIN // 2)
    train_cfg = pt.DistillConfig(**TRAIN_CFG)
    batch = [torch.from_numpy(data[f"train/{k}"][:, share]) for k in ("obs", "label", "reset")]
    loss = pt.bptt_loss(student, *batch, None, train_cfg.severe_weight, train_cfg.severe_tilt,
                        dist.group.WORLD)
    loss.backward()
    from raptor_tpu_torch.rl.sac import average_over

    grads = average_over(dist.group.WORLD, [p.grad for _, p in leaves])
    for (name, p), g in zip(leaves, grads):
        res[f"train/grad/{name}"] = g.numpy()
        p.grad = None
    opt = pt.make_optimizer(train_cfg)(student)
    loss_and_grads = pt._loss_and_grad(student, *batch, None, train_cfg, dist.group.WORLD)
    res["train/loss"] = pt._grad_step(student, opt, *loss_and_grads, dist.group.WORLD).numpy()
    for name, p in leaves:
        res[f"train/param/{name}"] = p.detach().numpy()

    # B3's plain version on this rank's rows, env ids offset by the rank, with
    # the handed student (not the one trained above)
    b3_params = dynamics_params_from_numpy(_unpack(data, "b3params"), "cpu")
    b3_state = state_from_numpy(_unpack(data, "b3state"), "cpu")
    rows = slice(rank * B3_ROWS, (rank + 1) * B3_ROWS)
    fused = make_fused_collect(from_numpy(_student_np(data), "cpu"), B3_STEPS,
                               EnvConfig(episode_length=5), device="cpu")
    obs, reset = fused(type(b3_params)(**{f.name: getattr(b3_params, f.name)[rows]
                                          for f in dataclasses.fields(b3_params)}),
                       type(b3_state)(**{f: getattr(b3_state, f)[rows] for f in STATE_FIELDS}),
                       3, rank * B3_ROWS)
    res["b3/obs"] = make_global_array(obs, 1).numpy()
    res["b3/reset"] = make_global_array(reset, 1).numpy()
    dist.destroy_process_group()
    np.savez(out, **res)


# ---------------------------------------------------------------------------
# the inputs, made by JAX and numpy
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def handed():
    """JAX airframes, teachers, student and the collect's initial states;
    minibatch columns from numpy; JAX-sampled airframes and states for B3."""
    import jax
    import jax.numpy as jnp

    from raptor_tpu.distill import population as jpopulation
    from raptor_tpu.env import EnvConfig as JEnvConfig
    from raptor_tpu.env import L2F as JL2F
    from raptor_tpu.env import sample_population as jsample
    from raptor_tpu.env.types import InitConfig as JInitConfig
    from raptor_tpu.env.types import TerminationConfig as JTerminationConfig
    from raptor_tpu.policy import network as jstudent_net
    from raptor_tpu.rl import networks as jnetworks

    np_ = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    jframes = jpopulation.sample_teacher_airframes(jax.random.key(0), K)
    jactors = jax.vmap(lambda k: jnetworks.actor_init(k, 31, 4, (16, 16)))(
        jax.random.split(jax.random.key(1), K))
    # the default head scale (0.01) gives labels near 0: scale it up so labels spread
    jactors["layers"][-1]["w"] = jactors["layers"][-1]["w"] * 60.0
    jstudent = jstudent_net.init_params(jax.random.key(2))
    # h0 = 0 at init would hide an error in its gradient path: move it
    jstudent["gru_1"]["initial_hidden_state"] = jnp.linspace(-0.3, 0.3, 16)
    jenv = JL2F(JEnvConfig(init=JInitConfig(**GENTLE), termination=JTerminationConfig(**WIDE)))
    key = jax.random.key(3)
    k_reset, _ = jax.random.split(key)
    jflat = jax.tree.map(lambda x: jnp.repeat(x, M, axis=0), jframes)
    es, _ = jax.vmap(jenv.reset)(jax.random.split(k_reset, K * M), jflat)

    data = {f"frames/{k}": v for k, v in vars(np_(jframes)).items()}
    for i, layer in enumerate(np_(jactors)["layers"]):
        data[f"actor/{i}/w"], data[f"actor/{i}/b"] = layer["w"], layer["b"]
    for layer, tensors in np_(jstudent).items():
        data.update({f"student/{layer}/{name}": v for name, v in tensors.items()})
    data.update({f"state/{f}": np.asarray(getattr(es.dynamics, f)) for f in STATE_FIELDS})
    rng = np.random.default_rng(0)
    obs = rng.normal(0, 0.6, (T_TRAIN, B_TRAIN, 22)).astype(np.float32)
    obs[..., 11] = np.where(rng.random((T_TRAIN, B_TRAIN)) < 0.4, -0.5, 0.9)  # some severe
    data["train/obs"] = obs
    data["train/label"] = rng.uniform(-1, 1, (T_TRAIN, B_TRAIN, 4)).astype(np.float32)
    data["train/reset"] = (rng.random((T_TRAIN, B_TRAIN)) < 0.25).astype(np.float32)
    b3frames = jsample(jax.random.key(4), 2 * B3_ROWS)
    b3es, _ = jax.vmap(JL2F(JEnvConfig()).reset)(jax.random.split(jax.random.key(5),
                                                                  2 * B3_ROWS), b3frames)
    data.update({f"b3params/{k}": v for k, v in vars(np_(b3frames)).items()})
    data.update({f"b3state/{f}": np.asarray(getattr(b3es.dynamics, f)) for f in STATE_FIELDS})
    return data, (jactors, jframes, jstudent, jenv, key)


def _run_ranks(handed, tmp_path_factory, layout):
    from raptor_tpu_torch.parallel.multihost import free_port

    tmp = tmp_path_factory.mktemp(f"gloo_distill_{layout}")
    inp = str(tmp / "in.npz")
    np.savez(inp, **handed[0])
    port, env = free_port(), dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--rank", str(r), "--port", str(port),
         "--inp", inp, "--out", str(tmp / f"rank{r}.npz"), "--layout", layout],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(2)]


@pytest.fixture(scope="module")
def two_ranks(handed, tmp_path_factory):
    """The ranks' results on the (1, 2) layout: one 'pop' block, two 'env'."""
    return _run_ranks(handed, tmp_path_factory, "1x2")


@pytest.fixture(scope="module")
def pop_ranks(handed, tmp_path_factory):
    """The ranks' results on the (2, 1) layout: two 'pop' blocks, one 'env'."""
    return _run_ranks(handed, tmp_path_factory, "2x1")


def _jax_collect(handed, case):
    import jax
    import jax.numpy as jnp

    from raptor_tpu.distill import population as jpopulation
    from raptor_tpu.distill import post_training as jpt

    jactors, jframes, jstudent, jenv, key = handed[1]
    beta, extra = CASES[case]
    student = jax.tree.map(jnp.asarray, jstudent)
    return jpt.make_collect(jenv, jpt.DistillConfig(envs_per_teacher=M, rollout_length=T,
                                                    **extra))(
        student, jactors, jpopulation.broadcast_airframe_to_envs(jframes, M), key, beta)


# ---------------------------------------------------------------------------
# the 2-process run against JAX
# ---------------------------------------------------------------------------


def _check_block_collect(handed, ranks, case):
    jdata = _jax_collect(handed, case)
    assert float(np.asarray(jdata.reset).sum()) == 0.0  # no reset: no further draw matters
    for name in ("obs", "teacher_action", "reset"):
        a, b = (r[f"collect/{case}/{name}"] for r in ranks)
        np.testing.assert_array_equal(a, b)  # every rank gathers the same round
        assert a.shape[:2] == (T, K * M)
        np.testing.assert_allclose(a, np.asarray(getattr(jdata, name)), atol=2e-4, rtol=0,
                                   err_msg=f"{case}/{name}")
    if case == "demo":
        # the first two envs of each teacher (on (1, 2) all of rank 0's
        # block, none of rank 1's) execute the demonstrator, as in one process
        obs, label = (ranks[0][f"collect/demo/{k}"] for k in ("obs", "teacher_action"))
        driven = np.arange(K * M) % M < 2
        tilted = obs[:-1, :, 11] < np.cos(0.1)
        ran_label = np.all(obs[1:, :, 18:22] == label[:-1], -1)
        assert ran_label[:, driven][tilted[:, driven]].all()
        assert not ran_label[:, ~driven].any()


@pytest.mark.parametrize("case", list(CASES))
def test_block_collect_gathered_equals_jax(handed, two_ranks, case):
    _check_block_collect(handed, two_ranks, case)


@pytest.mark.parametrize("case", list(CASES))
def test_pop_block_collect_gathered_equals_jax(handed, pop_ranks, case):
    """On (2, 1) each rank collects two whole teachers: gathered in block
    order, JAX's collect over all K x M envs."""
    _check_block_collect(handed, pop_ranks, case)


def _check_subsample(handed, ranks, shape):
    import jax

    jactors, jframes = handed[1][:2]
    idx = ranks[0]["sub/idx"]
    np.testing.assert_array_equal(idx, ranks[1]["sub/idx"])
    assert len(set(idx.tolist())) == 2 and set(idx.tolist()) <= set(range(K))
    want = jax.tree.map(lambda x: np.asarray(x)[idx], (jactors, jframes))
    k_local, m_local = len(idx) // shape[0], M // shape[1]
    for r in ranks:
        # the rank's 'pop' block of the drawn teachers, with its 'env' block
        # of their envs
        block = slice(r["coords"][0] * k_local, (r["coords"][0] + 1) * k_local)
        np.testing.assert_array_equal(r["sub/w0"], want[0]["layers"][0]["w"][block])
        np.testing.assert_array_equal(r["sub/mass"],
                                      np.repeat(want[1].mass[block, None], m_local, 1))


def test_round_subsample_is_drawn_alike_and_split_in_blocks(handed, two_ranks):
    _check_subsample(handed, two_ranks, (1, 2))


def test_round_subsample_split_over_pop_blocks(handed, pop_ranks):
    _check_subsample(handed, pop_ranks, (2, 1))


def _check_aggregate_union(handed, ranks):
    """Two rounds (beta 0, then 1) fill both blocks exactly; the union of the
    blocks' columns is the multiset of JAX's aggregate columns after the
    same rounds (the gathered data handed to JAX's `make_aggregate_add`)."""
    import jax
    import jax.numpy as jnp

    from raptor_tpu.distill import post_training as jpt

    jcfg = jpt.DistillConfig(rollout_length=T, aggregate_capacity=AGG_CAPACITY)
    jagg = jpt.aggregate_init(jcfg)
    add = jpt.make_aggregate_add(jcfg)
    for case in ("beta0", "beta1"):
        r = ranks[0]
        jagg = add(jagg, jpt.RoundData(*(jnp.asarray(r[f"collect/{case}/{k}"])
                                         for k in ("obs", "teacher_action", "reset"))),
                   jax.random.key(0))
    assert int(jagg.size) == AGG_CAPACITY
    for r in ranks:
        assert int(r["agg/size"]) == AGG_CAPACITY // 2

    def columns(obs, act, reset):
        full = np.concatenate([obs, act, reset[..., None]], -1).astype(np.float32)
        return Counter(full[:, c].tobytes() for c in range(full.shape[1]))

    want = columns(*(np.asarray(getattr(jagg, k).astype(jnp.float32))
                     for k in ("obs", "teacher_action", "reset")))
    got = sum((columns(r["agg/obs"], r["agg/teacher_action"], r["agg/reset"])
               for r in ranks), Counter())
    assert got == want


def test_aggregate_blocks_union_equals_jax_before_it_is_full(handed, two_ranks):
    _check_aggregate_union(handed, two_ranks)


def test_aggregate_pop_blocks_union_equals_jax_before_it_is_full(handed, pop_ranks):
    _check_aggregate_union(handed, pop_ranks)


def test_training_step_over_two_ranks_equals_jax_on_the_whole_minibatch(handed, two_ranks):
    import jax
    import jax.numpy as jnp
    import optax

    from raptor_tpu.distill import post_training as jpt

    data = handed[0]
    jcfg = jpt.DistillConfig(**TRAIN_CFG)
    jparams = jax.tree.map(jnp.asarray, handed[1][2])
    batch = [jnp.asarray(data[f"train/{k}"]) for k in ("obs", "label", "reset")]
    loss, grads = jax.value_and_grad(jpt.bptt_loss)(jparams, *batch, None, jcfg.severe_weight,
                                                    jcfg.severe_tilt)
    optim = jpt.make_optimizer(jcfg)
    updates, _ = optim.update(grads, optim.init(jparams), jparams)
    stepped = optax.apply_updates(jparams, updates)
    a, b = two_ranks
    names = [(layer, name) for layer in jparams for name in jparams[layer]]
    assert len(names) == 9 and len([k for k in a if k.startswith("train/param/")]) == 9
    for layer, name in names:
        key = f"{layer}/{name}"
        np.testing.assert_array_equal(a[f"train/param/{key}"], b[f"train/param/{key}"])
        want = np.asarray(grads[layer][name])
        assert np.abs(want).max() > 1e-4, key  # every leaf, h0 included, gets a gradient
        np.testing.assert_allclose(a[f"train/grad/{key}"], want, atol=1e-5 * np.abs(want).max(),
                                   rtol=0, err_msg=key)
        np.testing.assert_allclose(a[f"train/param/{key}"], np.asarray(stepped[layer][name]),
                                   atol=1e-5, rtol=0, err_msg=key)
    assert float(a["train/loss"]) == float(b["train/loss"])
    assert abs(float(a["train/loss"]) - float(loss)) < 1e-5


def test_b3_plain_over_two_ranks_equals_one_process(handed, two_ranks):
    from raptor_tpu_torch.ops.collect import make_fused_collect

    data = handed[0]
    student = from_numpy(_student_np(data), "cpu")
    obs, reset = make_fused_collect(student, B3_STEPS, EnvConfig(episode_length=5),
                                    device="cpu")(
        dynamics_params_from_numpy(_unpack(data, "b3params"), "cpu"),
        state_from_numpy(_unpack(data, "b3state"), "cpu"), 3, 0)
    assert 0.0 < float(reset.mean()) < 1.0  # episodes of 5 steps: fresh PRNG rows
    for r in two_ranks:
        np.testing.assert_array_equal(r["b3/obs"], obs.numpy())
        np.testing.assert_array_equal(r["b3/reset"], reset.numpy())


# ---------------------------------------------------------------------------
# the dry run and the layout's errors
# ---------------------------------------------------------------------------


def test_dryrun_multichip_on_two_cpu_processes():
    from raptor_tpu_torch.parallel.dryrun import dryrun_multichip

    report = dryrun_multichip(2, platform="cpu", timeout=300)
    assert report["devices"] == 2 and report["backend"] == "gloo"
    ranks = report["ranks"]
    assert [r["rank"] for r in ranks] == [0, 1]
    for r in ranks:
        assert np.isfinite(r["sac_critic_loss"])
        assert np.all(np.isfinite(r["population_critic_loss"]))
        assert len(r["distill_losses"]) == 2 and np.all(np.isfinite(r["distill_losses"]))
        assert r["b3_equals_one_launch"]
    assert ranks[0]["distill_losses"] == ranks[1]["distill_losses"]
    assert report["launches"] == dict.fromkeys(
        ("rollout", "eval", "collect", "fma_peak", "bptt"), 0)


def test_layout_raises_where_a_batch_or_a_round_does_not_split():
    from raptor_tpu_torch.parallel import Mesh, round_teacher_block, shard_distill_config

    mesh = Mesh(("pop", "env"), (2, 2), (1, 0))
    part = shard_distill_config(pt.DistillConfig(envs_per_teacher=8, teachers_per_round=4,
                                                 aggregate_capacity=64, batch_size=8), mesh)
    assert (part.envs_per_teacher, part.teachers_per_round, part.aggregate_capacity,
            part.batch_size) == (4, 2, 16, 2)
    with pytest.raises(ValueError, match="batch_size 6 over 4"):
        shard_distill_config(pt.DistillConfig(batch_size=6, aggregate_capacity=64), mesh)
    with pytest.raises(ValueError, match="teachers_per_round 3 over 2"):
        shard_distill_config(pt.DistillConfig(batch_size=8, teachers_per_round=3), mesh)
    frames = population.sample_teacher_airframes(torch.Generator().manual_seed(0), 6)
    from raptor_tpu_torch.rl import networks

    actors = networks.actor_init(torch.Generator().manual_seed(1), 31, 4, (8, 8), n_stack=6)
    env_params = population.broadcast_airframe_to_envs(frames, 4)
    with pytest.raises(ValueError, match="do not split over 2"):
        round_teacher_block(actors, env_params,
                            pt.draw_round_teachers(torch.Generator().manual_seed(2), 6, 3), mesh)
    idx = pt.draw_round_teachers(torch.Generator().manual_seed(2), 6, 4)
    sub_actors, sub_params = round_teacher_block(actors, env_params, idx, mesh)
    assert torch.equal(sub_actors["layers"][0]["w"], actors["layers"][0]["w"][idx[2:]])
    assert sub_params.mass.shape == (2, 2)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--inp", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--layout", choices=list(LAYOUTS), default="1x2")
    a = ap.parse_args()
    worker(a.rank, a.port, a.inp, a.out, a.layout)
