"""The port's multi-device layer (`raptor_tpu_torch/parallel/`) and
`apps/bench_scaling.py`, on the CPU.

- `mesh_shape` equals the shape of JAX's `make_mesh` for n = 1 to 8, and
  `scaling_report` JAX's report;
- a 2-process gloo run (this file run as a script, once per rank):
  - a sharded env rollout equals the single-process one and the JAX rollout
    from handed-across airframes and states;
  - two updates of a replicated learner, each process on its half of the
    minibatch, leave the learners equal across ranks bit for bit, and equal
    to the single-process update and to two of JAX's `sac_update` on the
    whole minibatch, from the same learner and noise, to 1e-5 (the gradients
    are averaged in another order);
  - one sharded SAC super-step keeps the ranks' learners equal bit for bit;
  - `host_generator` streams differ between ranks, and rank 0 draws what one
    process draws;
- `initialize_distributed` is a no-op in a single process;
- `bench_scaling --platform cpu --devices 1,2` writes both rows.
"""

import argparse
import json
import os
import socket
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:  # run as a script (a worker), the package lies one up
    sys.path.insert(0, ROOT)

from raptor_tpu_torch.checkpoint import (  # noqa: E402
    critic_from_numpy, dynamics_params_from_numpy, mlp_from_numpy, state_from_numpy)
from raptor_tpu_torch.env import EnvConfig, EnvState, L2F, sample_population  # noqa: E402
from raptor_tpu_torch.rl import networks, runner, sac  # noqa: E402

N_ENVS, STEPS, BATCH, OBS = 8, 5, 16, 31
SAC_CFG = sac.SACConfig(actor_hidden=(32, 32), critic_hidden=(32, 32))
STATE_FIELDS = ("position", "orientation", "linear_velocity", "angular_velocity", "rpm")


def rollout(params, state, actions):
    """STEPS env steps from the given states, one action a step: the
    observations [STEPS, N, d] and the done flags."""
    env = L2F(EnvConfig())
    n = state.position.shape[0]
    es = EnvState(dynamics=state, action_history=torch.zeros(n, 1, 4),
                  angvel_history=state.angular_velocity[:, None].clone(),
                  t=torch.zeros(n, dtype=torch.int32))
    gen, obs, done = torch.Generator().manual_seed(0), [], []
    for a in actions:
        es, o, _, d, _ = env.step(params, es, a, gen)
        obs.append(o)
        done.append(d)
    return torch.stack(obs), torch.stack(done)


def learner():
    return sac.sac_init(torch.Generator().manual_seed(3), OBS, 4, SAC_CFG)


def flat_learner(state) -> np.ndarray:
    leaves = [*networks.tree_leaves(state.actor), *networks.tree_leaves(state.critic),
              *networks.tree_leaves(state.target_critic), state.log_alpha]
    return torch.cat([x.detach().reshape(-1) for x in leaves]).numpy()


def updates(state, data, rows=slice(None), group=None):
    """Two SAC updates on the handed minibatches and noise, restricted to
    `rows`."""
    for i in range(2):
        batch = tuple(torch.as_tensor(data[f"batch{i}/{k}"][rows])
                      for k in ("obs", "action", "reward", "next_obs", "done"))
        noise = (torch.as_tensor(data[f"noise{i}/next"][rows]),
                 torch.as_tensor(data[f"noise{i}/pi"][rows]))
        state, metrics = sac.sac_update(state, None, batch, SAC_CFG, noise=noise, group=group)
    return state, metrics


def worker(rank: int, port: int, inp: str, out: str) -> None:
    """One rank of the 2-process run; writes its results to `out`."""
    import torch.distributed as dist

    from raptor_tpu_torch.parallel import (
        make_mesh, replicate_pytree, shard_env_pytree, shard_runner_config, shard_trainer_state)
    from raptor_tpu_torch.parallel.multihost import (
        host_generator, initialize_distributed, make_global_array, process_count, process_index)

    initialize_distributed(f"localhost:{port}", 2, rank, "cpu")
    initialize_distributed(f"localhost:{port}", 2, rank, "cpu")  # a second call: a no-op
    data = dict(np.load(inp))
    res = {"process": np.array([process_index(), process_count()]),
           "host_draw": torch.randn(4, generator=host_generator(7)).numpy()}
    mesh = make_mesh(2, ("env",))
    mesh2 = make_mesh(None, ("pop", "env"))
    res["mesh2_shape"], res["mesh2_coords"] = np.array(mesh2.shape), np.array(mesh2.coords)

    # the sharded rollout, gathered
    params = dynamics_params_from_numpy(
        {k.split("/", 1)[1]: v for k, v in data.items() if k.startswith("params/")}, "cpu")
    state = state_from_numpy(
        {k.split("/", 1)[1]: v for k, v in data.items() if k.startswith("state/")}, "cpu")
    actions = torch.as_tensor(data["actions"])
    obs, done = rollout(shard_env_pytree(params, mesh), shard_env_pytree(state, mesh),
                        shard_env_pytree(actions, mesh, env_axis=1))
    res["rollout_obs"] = make_global_array(obs, axis=1).numpy()
    res["rollout_done"] = make_global_array(done.int(), axis=1).numpy()

    # a replicated learner, each rank on its half of every minibatch
    half = slice(rank * BATCH // 2, (rank + 1) * BATCH // 2)
    state_r, metrics = updates(replicate_pytree(learner(), mesh), data, half, dist.group.WORLD)
    res["update_learner"] = flat_learner(state_r)
    res["update_critic_loss"] = metrics.critic_loss.numpy()

    # one sharded super-step of one learner on 8 envs
    env = L2F(EnvConfig())
    run_cfg = runner.RunnerConfig(n_envs=N_ENVS, rollout_length=4, gradient_steps=2,
                                  batch_size=BATCH, replay_capacity=32)
    full_params = sample_population(torch.Generator().manual_seed(0), N_ENVS)
    full = runner.trainer_init(torch.Generator().manual_seed(1), env, full_params, run_cfg,
                               SAC_CFG)
    local = shard_trainer_state(full, mesh)
    local_cfg = shard_runner_config(run_cfg, mesh)
    local_params = shard_env_pytree(full_params, mesh)
    res["ss_obs_is_block"] = np.array(torch.equal(local.obs, full.obs[rank * 4:(rank + 1) * 4]))
    local = runner.make_warmup_step(env, local_cfg)(local, local_params)
    local, m = runner.make_super_step(env, local_cfg, SAC_CFG, dist.group.WORLD)(
        local, local_params)
    res["ss_learner"] = flat_learner(local.sac)
    res["ss_critic_loss"] = m.critic_loss.numpy()
    res["ss_buffer_shape"] = np.array(local.buffer.obs.shape)
    res["ss_batch_share"] = np.array(local_cfg.batch_size)
    dist.destroy_process_group()
    np.savez(out, **res)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def handed():
    """JAX airframes, reset states and a JAX rollout of them; minibatches
    from numpy, and the noise JAX's `sac_update` draws from the keys
    `key(100 + i)`."""
    import jax

    from raptor_tpu.env import EnvConfig as JEnvConfig
    from raptor_tpu.env import L2F as JL2F
    from raptor_tpu.env import sample_population as jsample

    jenv = JL2F(JEnvConfig())
    jparams = jsample(jax.random.key(0), N_ENVS)
    v_reset, v_step = jenv.vector_ops()
    es, _ = v_reset(jax.random.split(jax.random.key(1), N_ENVS), jparams)
    rng = np.random.default_rng(0)
    actions = rng.uniform(-0.3, 0.3, (STEPS, N_ENVS, 4)).astype(np.float32)
    jobs, jdone, jes = [], [], es
    for a in actions:
        jes, o, _, d, _ = jax.jit(v_step)(jparams, jes, a)
        jobs.append(np.asarray(o))
        jdone.append(np.asarray(d))
    data = {f"params/{k}": np.asarray(v) for k, v in vars(jparams).items()}
    data.update({f"state/{k}": np.asarray(getattr(es.dynamics, k)) for k in STATE_FIELDS})
    data["actions"] = actions
    for i in range(2):
        data.update({
            f"batch{i}/obs": rng.standard_normal((BATCH, OBS)).astype(np.float32),
            f"batch{i}/action": rng.uniform(-1, 1, (BATCH, 4)).astype(np.float32),
            f"batch{i}/reward": rng.standard_normal(BATCH).astype(np.float32),
            f"batch{i}/next_obs": rng.standard_normal((BATCH, OBS)).astype(np.float32),
            f"batch{i}/done": (rng.random(BATCH) < 0.2).astype(np.float32),
        })
        # sac_update's draws from its key: k_next, k_pi = split(key)
        k_next, k_pi = jax.random.split(jax.random.key(100 + i))
        data[f"noise{i}/next"] = np.array(jax.random.normal(k_next, (BATCH, 4)))
        data[f"noise{i}/pi"] = np.array(jax.random.normal(k_pi, (BATCH, 4)))
    return data, np.stack(jobs), np.stack(jdone)


@pytest.fixture(scope="module")
def two_ranks(handed, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gloo")
    inp = str(tmp / "in.npz")
    np.savez(inp, **handed[0])
    port, env = _free_port(), dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--rank", str(r), "--port", str(port),
         "--inp", inp, "--out", str(tmp / f"rank{r}.npz")],
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


def test_two_processes_join_one_gloo_group(two_ranks):
    assert [list(r["process"]) for r in two_ranks] == [[0, 2], [1, 2]]
    assert all(list(r["mesh2_shape"]) == [1, 2] for r in two_ranks)
    assert [list(r["mesh2_coords"]) for r in two_ranks] == [[0, 0], [0, 1]]


def test_sharded_rollout_equals_one_process_and_jax(handed, two_ranks):
    data, jobs, jdone = handed
    assert not jdone.any()  # no reset: the rollouts are functions of the handed states
    params = dynamics_params_from_numpy(
        {k.split("/", 1)[1]: v for k, v in data.items() if k.startswith("params/")}, "cpu")
    state = state_from_numpy(
        {k.split("/", 1)[1]: v for k, v in data.items() if k.startswith("state/")}, "cpu")
    obs, done = rollout(params, state, torch.as_tensor(data["actions"]))
    for r in two_ranks:
        np.testing.assert_array_equal(r["rollout_obs"], obs.numpy())
        np.testing.assert_array_equal(r["rollout_done"], done.int().numpy())
    # the JAX package's own tolerance for its dynamics (tests/test_torch_env.py)
    np.testing.assert_allclose(two_ranks[0]["rollout_obs"], jobs, atol=1e-5)


def test_replicated_update_is_bit_equal_across_ranks_and_matches_one_process(handed,
                                                                            two_ranks):
    one, metrics = updates(learner(), handed[0])
    a, b = (r["update_learner"] for r in two_ranks)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(a, flat_learner(one), atol=1e-5, rtol=0)
    assert np.abs(a - flat_learner(learner())).max() > 1e-4  # the update moved the learner
    np.testing.assert_allclose(two_ranks[0]["update_critic_loss"], metrics.critic_loss.numpy(),
                               rtol=1e-5)


def test_replicated_update_matches_jax(handed, two_ranks):
    """Rank 0's learner after two updates on its half of each minibatch
    equals two of JAX's `sac_update` on the whole minibatches, from the
    port's initial learner handed across and the keys the noise came from:
    1e-5 on every leaf and on the critic loss."""
    import jax
    import jax.numpy as jnp

    from raptor_tpu.rl import sac as jsac

    data = handed[0]
    start = learner()
    to_jax = lambda tree: jax.tree.map(lambda x: jnp.asarray(x.detach().numpy()), tree)  # noqa: E731
    jcfg = jsac.SACConfig(actor_hidden=(32, 32), critic_hidden=(32, 32))
    jstate = jsac.sac_init(jax.random.key(0), OBS, 4, jcfg).replace(
        actor=to_jax(start.actor), critic=to_jax(start.critic),
        target_critic=to_jax(start.target_critic), log_alpha=to_jax(start.log_alpha))
    for i in range(2):
        batch = tuple(jnp.asarray(data[f"batch{i}/{k}"])
                      for k in ("obs", "action", "reward", "next_obs", "done"))
        jstate, jm = jsac.sac_update(jstate, jax.random.key(100 + i), batch, jcfg)
    ref = jax.tree.map(np.asarray, jstate)
    want = flat_learner(types.SimpleNamespace(
        actor=mlp_from_numpy(ref.actor, "cpu"), critic=critic_from_numpy(ref.critic, "cpu"),
        target_critic=critic_from_numpy(ref.target_critic, "cpu"),
        log_alpha=torch.tensor(np.array(ref.log_alpha))))
    np.testing.assert_allclose(two_ranks[0]["update_learner"], want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(two_ranks[0]["update_critic_loss"], np.asarray(jm.critic_loss),
                               rtol=1e-5)


def test_sharded_super_step_keeps_the_learners_equal(two_ranks):
    a, b = (r["ss_learner"] for r in two_ranks)
    np.testing.assert_array_equal(a, b)
    assert np.all(np.isfinite(a))
    np.testing.assert_array_equal(two_ranks[0]["ss_critic_loss"], two_ranks[1]["ss_critic_loss"])
    for r in two_ranks:
        assert bool(r["ss_obs_is_block"])
        assert list(r["ss_buffer_shape"]) == [32, N_ENVS // 2, OBS]
        assert int(r["ss_batch_share"]) == BATCH // 2


def test_host_generator_streams(two_ranks):
    from raptor_tpu_torch.parallel.multihost import host_generator

    draws = [r["host_draw"] for r in two_ranks]
    assert np.abs(draws[0] - draws[1]).max() > 1e-3
    np.testing.assert_array_equal(draws[0], torch.randn(4, generator=host_generator(7)).numpy())
    np.testing.assert_array_equal(
        draws[0], torch.randn(4, generator=torch.Generator().manual_seed(7)).numpy())
    np.testing.assert_array_equal(
        draws[1], torch.randn(4, generator=host_generator(7, process_index=1)).numpy())


# ------------------------------------------------------------- one process


def test_initialize_distributed_is_a_no_op_in_one_process(monkeypatch):
    import torch.distributed as dist

    from raptor_tpu_torch.parallel.multihost import (
        global_env_count, initialize_distributed, make_global_array, process_count)

    for var in ("MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    initialize_distributed(device="cpu")
    assert not dist.is_initialized() and process_count() == 1
    assert global_env_count(32) == 32
    x = torch.arange(6.0).reshape(2, 3)
    assert torch.equal(make_global_array(x, axis=1), x)


def test_mesh_shapes_equal_jax():
    from raptor_tpu.parallel import make_mesh as j_make_mesh

    from raptor_tpu_torch.parallel import mesh_shape

    for n in range(1, 9):
        assert mesh_shape(n) == j_make_mesh(n).devices.shape
        assert mesh_shape(n, ("pop", "env")) == j_make_mesh(n, ("pop", "env")).devices.shape
    with pytest.raises(ValueError):
        mesh_shape(8, ("a", "b", "c"))


def test_scaling_report_equals_jax():
    from raptor_tpu.parallel.multihost import scaling_report as j_scaling_report

    from raptor_tpu_torch.parallel.multihost import scaling_report

    for args in ((100.0, 640.0, 8), (250.0, 400.0, 2), (0.0, 5.0, 4)):
        assert scaling_report(*args) == j_scaling_report(*args)


def test_local_block_is_the_named_sharding_order():
    """Process r of n holds rows [r L / n, (r + 1) L / n) of the mesh axis
    it is split over; a length that does not divide raises."""
    from raptor_tpu_torch.parallel import Mesh, local_block, shard_buffer_pytree

    x = torch.arange(24.0).reshape(12, 2)
    for rank in range(3):
        mesh = Mesh(("pop", "env"), (1, 3), (0, rank))
        assert torch.equal(local_block(x, mesh, 0), x[4 * rank:4 * (rank + 1)])
        buf = runner.replay.transition_buffer_init(5, 6, 3, 4, "cpu")
        buf.obs += torch.arange(6.0)[None, :, None]
        got = shard_buffer_pytree(buf, mesh)
        assert got.obs.shape == (5, 2, 3) and got.ptr == buf.ptr
        assert torch.equal(got.obs, buf.obs[:, 2 * rank:2 * (rank + 1)])
    with pytest.raises(ValueError):
        local_block(torch.zeros(7), mesh, 0)
    with pytest.raises(ValueError):
        local_block(x, mesh, 0, mesh_dim="data")


def test_bench_scaling_cpu_writes_both_rows(tmp_path, capsys):
    from raptor_tpu_torch.apps import bench_scaling

    out = tmp_path / "scaling.json"
    report = bench_scaling.main([
        "--platform", "cpu", "--devices", "1,2", "--teachers-per-device", "2",
        "--envs-per-teacher", "4", "--rollout-length", "4", "--gradient-steps", "2",
        "--batch-size", "16", "--replay-capacity", "32", "--iters-lo", "1", "--iters-hi", "2",
        "--out", str(out)])
    assert json.loads(out.read_text()) == report
    rows = report["rows"]
    assert [r["devices"] for r in rows] == [1, 2]
    assert [r["teachers"] for r in rows] == [2, 4]
    assert all(r["backend"] == "gloo" and r["processes"] == r["devices"] for r in rows)
    assert all(np.isfinite(r["critic_loss"]) and r["env_steps_per_s"] > 0 for r in rows)
    # the super-step is eager PyTorch: no process launched a kernel
    assert all(r["launches"] == dict.fromkeys(("rollout", "eval", "collect", "fma_peak", "bptt"),
                                              0)
               for r in rows)
    assert report["scaling"][0]["scaling_efficiency"] == 1.0
    assert "NOT the scaling of cards" in report["note"]


def test_bench_scaling_refuses_more_cards_than_present():
    from raptor_tpu_torch.apps import bench_scaling

    with pytest.raises(ValueError):
        bench_scaling.main(["--platform", "cuda", "--devices",
                            str(torch.cuda.device_count() + 1)])


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--inp", required=True)
    ap.add_argument("--out", required=True)
    a = ap.parse_args()
    worker(a.rank, a.port, a.inp, a.out)
