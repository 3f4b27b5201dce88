"""Each plain reference agrees with the port at a tiny size on the CPU, and
the control (the reference in TF32 in the program's place) fails the cells'
limits where the program passes them."""

import dataclasses

import pytest
import torch

import tinycell

import control
import core
from reference import quad, student

from raptor_tpu_torch.distill import post_training as pt
from raptor_tpu_torch.env import L2F
from raptor_tpu_torch.env.randomization import sample_population
from raptor_tpu_torch.env.types import EnvConfig, InitConfig, tree_map
from raptor_tpu_torch.ops import eval as ops_eval

SEED = 2**31 + 77


def gen(seed):
    return torch.Generator().manual_seed(seed)


def eval_config():
    return tinycell.cell("eval_population").config["eval"]


def program_population(n_air, per, ev):
    frames = sample_population(gen(SEED), n_air)
    params = tree_map(lambda x: x.repeat_interleave(per, 0), frames)
    env = L2F(EnvConfig(init=InitConfig(**ev["init"])))
    return params, env.reset(params, gen(SEED + 1))[0].dynamics


def test_sampler_and_reset_equal_the_port_bit_for_bit():
    ev = eval_config()
    params, state = program_population(37, 3, ev)
    p = quad.repeat_envs(quad.sample_airframes(gen(SEED), 37), 3)
    s = quad.sample_states(p, gen(SEED + 1), ev["init"])
    assert torch.equal(params.to_soa(), quad.to_rows(p, quad.PARAM_ROWS))
    assert torch.equal(state.to_soa(), quad.to_rows(s, quad.STATE_ROWS))


def test_closed_loop_agrees_with_the_port():
    ev = eval_config()
    params, state = program_population(16, 2, ev)
    path = f"{tinycell.ROOT}/raptor_tpu_torch/data/student_rateFlagCurMix.npz"
    weights = core.load_module("kinds", "eval").load_weights(path, torch.device("cpu"))
    policy = {}
    for name, t in weights.items():
        layer, leaf = name.split("/")
        policy.setdefault(layer, {})[leaf] = t
    out, stats = ops_eval.eval_soa(ops_eval.flatten_policy(policy), params.to_soa(),
                                   state.to_soa(), 120)
    p = quad.repeat_envs(quad.sample_airframes(gen(SEED), 16), 2)
    s = quad.sample_states(p, gen(SEED + 1), ev["init"])
    final, alive, length, ret = quad.closed_loop(weights, p, s, 120, ev)
    assert torch.equal(stats[0] != 0, alive)
    assert torch.equal(stats[1], length)
    torch.testing.assert_close(stats[2], ret, atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(out, quad.to_rows(final, quad.STATE_ROWS), atol=1e-5, rtol=1e-5)
    assert 0 < float(alive.float().mean())


def test_bptt_loss_and_gradients_agree_with_the_port():
    w0 = student.init_weights(gen(SEED), 16)
    obs = torch.randn((30, 5, 22), generator=gen(1))
    label = torch.rand((30, 5, 4), generator=gen(2)) * 2 - 1
    reset = (torch.rand((30, 5), generator=gen(3)) < 0.1).float()
    leaves = {k: v.clone().requires_grad_(True) for k, v in w0.items()}
    ref_loss = student.bptt_loss(leaves, obs, label, reset)
    ref_grads = torch.autograd.grad(ref_loss, list(leaves.values()))
    nested = {}
    for name, t in w0.items():
        layer, leaf = name.split("/")
        nested.setdefault(layer, {})[leaf] = t.clone().requires_grad_(True)
    loss = pt.bptt_loss(nested, obs, label, reset)
    grads = torch.autograd.grad(loss, [nested[n.split("/")[0]][n.split("/")[1]] for n in w0])
    torch.testing.assert_close(loss, ref_loss, atol=0, rtol=1e-6)
    for g, r in zip(grads, ref_grads):
        torch.testing.assert_close(g, r, atol=1e-7, rtol=1e-5)


def test_learning_rate_follows_the_program_schedule():
    cfg = pt.DistillConfig(**tinycell.cell("distill_train").config["distill_config"])
    schedule = pt.lr_schedule(cfg)
    ref_cfg = {k: getattr(cfg, k) for k in dataclasses.asdict(cfg)}
    for step in (0, 1, 1000, 2920, 2921, 2922, 80000, 146079, 146080, 200000):
        assert student.lr_at(step, ref_cfg) == pytest.approx(schedule(step), rel=1e-12)


@pytest.mark.parametrize("workload", ["distill_train", "eval_population", "eval_checkpoints",
                                      "farm_wave"])
def test_control_fails_where_the_program_passes(workload):
    cell = tinycell.tiny(tinycell.cell(workload))
    reading = control.readings(cell, SEED, 0.5, torch.device("cpu"))
    assert core.judge(reading["program"], cell.limits)[0] is True, reading
    assert core.judge(reading["tf32"], cell.limits)[0] is False, reading


def test_farm_start_equals_the_port_bit_for_bit():
    """The reference's wave starts where the program's does: the same
    airframes, actors, critics, temperature and first observations from one
    seed (the stage the check's replay begins from)."""
    from raptor_tpu_torch.distill import population
    from raptor_tpu_torch.rl.sac import SACConfig

    from reference import sac as ref_sac

    cell = tinycell.tiny(tinycell.cell("farm_wave"))
    cfg = cell.config
    env = L2F(EnvConfig(init=InitConfig(**cfg["env"]["init"])))
    g = gen(SEED)
    airframes = population.sample_teacher_airframes(g, cfg["population"]["n_teachers"])
    states, _, _ = population.population_init(
        g, env, airframes, population.PopulationConfig(**cfg["population"]), SACConfig())
    farm = ref_sac.Farm(SEED, cfg, torch.device("cpu"))
    program = core.load_module("kinds", "farm").program_leaves(states.sac)
    for name, value in farm.weights().items():
        assert torch.equal(program[name], value), name
    assert torch.equal(states.obs, farm.obs)
