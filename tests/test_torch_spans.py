"""The port's phase spans (`utils.profiling.span`) on the CPU: with no
profiler running a span is the shared null context and records nothing;
under `torch.profiler` a distillation step records its step, gather,
forward, backward and optimizer spans, nested in that order over their
operators, and changes no result; an evaluation records its sample, reset,
pack, launch, unpack and summary spans; an env step opens none."""

import contextlib

import torch
from torch.profiler import ProfilerActivity, profile

from raptor_tpu_torch.distill import post_training as pt
from raptor_tpu_torch.env import L2F, EnvConfig
from raptor_tpu_torch.env.randomization import sample_population
from raptor_tpu_torch.ops import eval as ops_eval
from raptor_tpu_torch.policy import network
from raptor_tpu_torch.rl import evaluation
from raptor_tpu_torch.utils.profiling import span

STEP_CHILDREN = ["raptor.distill.gather", "raptor.distill.forward", "raptor.distill.backward",
                 "raptor.distill.optimizer"]
EVAL_SPANS = ["raptor.env.sample_population", "raptor.env.reset", "raptor.ops.eval.pack",
              "raptor.ops.eval.launch", "raptor.ops.eval.unpack", "raptor.rl.summarize"]


def host_events(prof):
    """(name, start ns, end ns) of every host event, in start order."""
    evs = [(e.name(), e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()]
    return sorted(evs, key=lambda e: (e[1], -e[2]))


def named(events, prefix="raptor."):
    return [e for e in events if e[0].startswith(prefix)]


def inside(outer, events):
    return [e for e in events if outer[1] <= e[1] and e[2] <= outer[2] and e != outer]


def test_span_without_a_profiler_is_the_shared_null_context():
    assert not torch.autograd._profiler_enabled()
    a, b = span("distill.step"), span("env.reset")
    assert a is b and isinstance(a, contextlib.nullcontext)
    with a, b:  # reentrant: nested spans share it
        pass


def test_span_under_a_profiler_is_a_raptor_range_over_its_operators():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("outer"):
            with span("inner"):
                torch.ones(4) + 1
    events = host_events(prof)
    outer, inner = named(events)
    assert (outer[0], inner[0]) == ("raptor.outer", "raptor.inner")
    assert inner in inside(outer, events)
    assert any(e[0] == "aten::add" for e in inside(inner, events))
    assert span("outer") is span("inner")  # the profiler has stopped


def tiny_trainer(seed=5, t=10, cap=12, batch=4, steps=1):
    cfg = pt.DistillConfig(rollout_length=t, aggregate_capacity=cap, batch_size=batch,
                           grad_steps_per_round=steps, total_grad_steps=8)
    g = torch.Generator().manual_seed(seed)
    agg = pt.aggregate_init(cfg, "cpu")
    data = pt.RoundData(torch.randn((t, cap, 22), generator=g),
                        torch.rand((t, cap, 4), generator=g) * 2 - 1,
                        (torch.rand((t, cap), generator=g) < 0.1).float())
    pt.make_aggregate_add(cfg)(agg, data, g)
    train_round, optim_init = pt.make_train_from_aggregate(cfg)
    student = network.init_params(torch.Generator().manual_seed(seed + 1))
    for layer in student.values():
        for leaf in layer.values():
            leaf.requires_grad_(True)
    return train_round, student, optim_init(student), agg, torch.Generator().manual_seed(seed + 2)


def run_round(profiled):
    train_round, student, opt, agg, gen = tiny_trainer()
    with profile(activities=[ProfilerActivity.CPU]) if profiled else contextlib.nullcontext() \
            as prof:
        student, opt, losses = train_round(student, opt, agg, gen)
    adam = opt[0]
    moments = [adam.state[p][k].clone() for p in adam.param_groups[0]["params"]
               for k in ("exp_avg", "exp_avg_sq")]
    weights = [leaf.detach().clone() for layer in student.values() for leaf in layer.values()]
    return losses, moments, weights, prof


def test_train_round_step_spans_nest_in_order_and_change_nothing():
    losses, moments, weights, prof = run_round(profiled=True)
    events = host_events(prof)
    spans = named(events)
    step = spans[0]
    assert [s[0] for s in spans] == ["raptor.distill.step"] + STEP_CHILDREN
    children = inside(step, spans)
    assert [c[0] for c in children] == STEP_CHILDREN
    for before, after in zip(children, children[1:]):
        assert before[2] <= after[1]
    for child in children:
        assert any(e[0].startswith("aten::") for e in inside(child, events)), child[0]

    plain_losses, plain_moments, plain_weights, _ = run_round(profiled=False)
    assert torch.equal(losses, plain_losses)
    for a, b in zip(moments + weights, plain_moments + plain_weights):
        assert torch.equal(a, b)  # bit for bit: the first moment holds the gradient


def test_train_epoch_opens_the_grad_step_spans():
    cfg = pt.DistillConfig(rollout_length=6, batch_size=4)
    g = torch.Generator().manual_seed(3)
    data = pt.RoundData(torch.randn((6, 8, 22), generator=g), torch.rand((6, 8, 4), generator=g),
                        torch.zeros((6, 8)))
    train_epoch, optim_init = pt.make_train_epoch(cfg)
    student = network.init_params(torch.Generator().manual_seed(4))
    for layer in student.values():
        for leaf in layer.values():
            leaf.requires_grad_(True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        train_epoch(student, optim_init(student), data, g)
    names = [s[0] for s in named(host_events(prof))]
    assert names == STEP_CHILDREN[1:] * 2  # two batches of 4


def test_evaluation_records_its_spans_through_eval_plain():
    env, n = L2F(EnvConfig(episode_length=12)), 6
    policy = network.init_params(torch.Generator().manual_seed(7))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        params = sample_population(torch.Generator().manual_seed(8), n)
        es, _ = env.reset(params, torch.Generator().manual_seed(9))
        _, alive, length, ret = ops_eval.fused_policy_eval(
            policy, params, es.dynamics, env.EPISODE_LENGTH, device="cpu")
        stats = evaluation.summarize(ret, length, alive)
    names = [s[0] for s in named(host_events(prof))]
    assert names == EVAL_SPANS[:3] + EVAL_SPANS[2:]  # the weights' pack, then the inputs'
    assert len(names) <= 8
    assert all(torch.isfinite(torch.as_tensor(list(stats))))


def test_env_step_opens_no_span():
    """The auto-reset inside `L2F.step` runs every time step: no span."""
    env, n = L2F(EnvConfig(episode_length=5)), 4
    g = torch.Generator().manual_seed(1)
    params = sample_population(g, n)
    es, _ = env.reset(params, g)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            es, *_ = env.step(params, es, torch.zeros((n, 4)), g)
    assert named(host_events(prof)) == []
