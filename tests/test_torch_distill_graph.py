"""The distillation step's loss and gradients as one CUDA graph replay
(`distill.post_training._StepGraph`), held to the eager step (`_grad_step`).

On the CPU nothing is captured: `_StepGraph.replay` runs the body the graph
captures on a card (the gather from the static index buffer, `bptt_loss`
and its backward) eagerly, and with the eager Adam step of `_grad_step` it
must match the eager `train_round` bit for bit: losses, leaves, Adam's
moments and the minibatch generator's state after every step. The routing
is held by forcing `_graph_steps` on: every step goes through `_grad_step`,
the process group and `make_train_epoch` without a graph, and a new
aggregate, optimizer or normalizer captures anew.

The tests marked `cuda` capture and replay on the card: against the eager
path with the same optimizer for 10 steps from the same weights and
generator, and against the CPU trainer (whose Adam the JAX package's optax
holds in `test_torch_distill.py`) over the same minibatches at the recipe's
size. The file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_distill_graph.py -q
"""

import statistics

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from raptor_tpu_torch.distill import post_training as pt
from raptor_tpu_torch.ops import bptt as ops_bptt
from raptor_tpu_torch.policy import network

CASES = {
    "constant": dict(total_grad_steps=0, severe_weight=1.0),
    "constant_severe": dict(total_grad_steps=0, severe_weight=2.0),
    "scheduled": dict(total_grad_steps=8, severe_weight=1.0),
    "scheduled_severe": dict(total_grad_steps=8, severe_weight=2.0),
}


def trainer(device, case, t=10, cap=12, batch=4, steps=1, seed=5):
    """A config, a filled aggregate, a student of leaves and a minibatch
    generator, all from `seed`; observations with some frames tilted past
    severe_tilt, so that severe_weight acts."""
    cfg = pt.DistillConfig(rollout_length=t, aggregate_capacity=cap, batch_size=batch,
                           grad_steps_per_round=steps, **CASES[case])
    g = torch.Generator(device=device).manual_seed(seed)
    obs = torch.randn((t, cap, 22), generator=g, device=device) * 0.6
    tilted = torch.rand((t, cap), generator=g, device=device) < 0.3
    obs[..., 11] = torch.where(tilted, -0.5, 0.9)
    data = pt.RoundData(obs, torch.rand((t, cap, 4), generator=g, device=device) * 2 - 1,
                        (torch.rand((t, cap), generator=g, device=device) < 0.1).float())
    agg = pt.aggregate_init(cfg, device)
    pt.make_aggregate_add(cfg)(agg, data, g)
    student = network.init_params(torch.Generator(device=device).manual_seed(seed + 1))
    for layer in student.values():
        for leaf in layer.values():
            leaf.requires_grad_(True)
    return cfg, agg, student, torch.Generator(device=device).manual_seed(seed + 2)


def snapshot(student, opt, gen):
    """Leaves, Adam's two moments by leaf, and the generator's state."""
    adam = opt[0]
    leaves = [leaf.detach().clone() for layer in student.values() for leaf in layer.values()]
    moments = [adam.state[p][k].clone() for p in adam.param_groups[0]["params"]
               for k in ("exp_avg", "exp_avg_sq")]
    return leaves, moments, gen.get_state()


def force_graph(monkeypatch):
    monkeypatch.setattr(pt, "_graph_steps", lambda device: True)


def graph_step(graph, student, opt, agg, gen, cfg):
    """One step as `train_round` takes it on a card: the draw into the
    graph's index buffer, then `_grad_step` with the graph."""
    torch.randint(0, max(agg.size, 1), (cfg.batch_size,), generator=gen, out=graph.idx)
    return pt._grad_step(student, opt, None, None, None, None, cfg, graph=graph)


# ---------------------------------------------------------------------------
# CPU: the static-buffer body against the eager step, and the routing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", list(CASES))
def test_static_buffer_step_is_the_eager_step_bit_for_bit(case):
    cfg, agg, student, gen = trainer("cpu", case)
    train_round, optim_init = pt.make_train_from_aggregate(cfg)
    opt = optim_init(student)
    ecfg, eagg, estudent, egen = trainer("cpu", case)
    etrain, eoptim_init = pt.make_train_from_aggregate(ecfg)
    eopt = eoptim_init(estudent)
    graph = pt._StepGraph(pt._step_key(student, opt, agg, None), student, opt, agg, None,
                          cfg)
    assert graph.graph is None  # nothing is captured on the CPU
    for _ in range(3):
        loss = graph_step(graph, student, opt, agg, gen, cfg)
        _, _, eloss = etrain(estudent, eopt, eagg, egen)
        assert torch.equal(loss, eloss[0])
        leaves, moments, state = snapshot(student, opt, gen)
        eleaves, emoments, estate = snapshot(estudent, eopt, egen)
        for a, b in zip(leaves + moments, eleaves + emoments):
            assert torch.equal(a, b)
        assert torch.equal(state, estate)
        assert all(p.grad is None for p in opt[0].param_groups[0]["params"])
    assert opt[1].last_epoch == eopt[1].last_epoch == 3
    assert opt[0].param_groups[0]["lr"] == eopt[0].param_groups[0]["lr"]


@pytest.mark.parametrize("case", ["constant_severe", "scheduled"])
def test_train_round_through_the_graph_path_matches_the_eager_round(monkeypatch, case):
    eager = []
    for forced in (False, True):
        cfg, agg, student, gen = trainer("cpu", case, steps=3)
        train_round, optim_init = pt.make_train_from_aggregate(cfg)
        opt = optim_init(student)
        with monkeypatch.context() as m:
            if forced:
                m.setattr(pt, "_graph_steps", lambda device: True)
            rows = []
            for _ in range(2):
                _, _, losses = train_round(student, opt, agg, gen)
                rows.append((losses, *snapshot(student, opt, gen)))
        if not forced:
            eager = rows
    for (losses, leaves, moments, state), (elosses, eleaves, emoments, estate) in zip(rows, eager):
        assert torch.equal(losses, elosses) and torch.equal(state, estate)
        for a, b in zip(leaves + moments, eleaves + emoments):
            assert torch.equal(a, b)


def test_process_group_and_epoch_trainer_take_the_eager_step(monkeypatch):
    cfg, agg, student, gen = trainer("cpu", "scheduled", steps=2)
    train_round, optim_init = pt.make_train_from_aggregate(cfg)
    opt = optim_init(student)
    train_round(student, opt, agg, gen)  # Adam has state: the graph path is open
    force_graph(monkeypatch)
    calls = []

    def eager_step(student_params, opt_, obs, lab, rst, norm, cfg_, group=None, graph=None):
        calls.append((group, graph, obs is None))
        return torch.zeros(())

    monkeypatch.setattr(pt, "_grad_step", eager_step)
    _, _, losses = train_round(student, opt, agg, gen)  # no group: the graph, in _grad_step
    assert [(g, type(s), o) for g, s, o in calls] == [(None, pt._StepGraph, True)] * 2
    assert calls[0][1] is calls[1][1] and losses.shape == (2,)
    calls.clear()
    group = object()  # never used by the stand-in step
    grouped, _ = pt.make_train_from_aggregate(cfg, group)
    _, _, losses = grouped(student, opt, agg, gen)
    assert calls == [(group, None, False)] * 2 and losses.shape == (2,)

    train_epoch, epoch_init = pt.make_train_epoch(cfg)
    data = pt.RoundData(agg.obs.float(), agg.teacher_action.float(), agg.reset.float())
    calls.clear()
    _, _, losses = train_epoch(student, epoch_init(student), data, gen)
    assert calls == [(None, None, False)] * 3 and losses.shape == (3,)  # 12 sequences, by 4


def test_a_new_aggregate_optimizer_or_normalizer_captures_anew(monkeypatch):
    force_graph(monkeypatch)
    built = []

    class Counted(pt._StepGraph):
        def __init__(self, *args):
            built.append(args[0])
            super().__init__(*args)

    monkeypatch.setattr(pt, "_StepGraph", Counted)
    cfg, agg, student, gen = trainer("cpu", "scheduled", steps=2)
    train_round, optim_init = pt.make_train_from_aggregate(cfg)
    opt = optim_init(student)
    train_round(student, opt, agg, gen)  # the first step eager, the second captures
    train_round(student, opt, agg, gen)
    assert len(built) == 1
    _, agg2, _, _ = trainer("cpu", "scheduled", steps=2)
    train_round(student, opt, agg2, gen)
    assert len(built) == 2
    train_round(student, opt, agg2, gen)
    opt2 = optim_init(student)
    train_round(student, opt2, agg2, gen)  # no state yet: eager, then a capture
    assert len(built) == 3 and opt2[1].last_epoch == 2
    norm = pt.identity_norm("cpu")
    train_round(student, opt2, agg2, gen, norm)
    train_round(student, opt2, agg2, gen, norm)
    assert len(built) == 4
    agg2.size = 5  # the filled prefix is the eager draw's bound, not in the graph
    train_round(student, opt2, agg2, gen, norm)
    assert len(built) == 4


def test_graph_step_spans_nest_in_order(monkeypatch):
    """The draw, the graph and the optimizer, in order inside the step; on
    the CPU the graph's body opens its forward and backward inside it (a
    replay on a card enters neither)."""
    force_graph(monkeypatch)
    cfg, agg, student, gen = trainer("cpu", "constant")
    train_round, optim_init = pt.make_train_from_aggregate(cfg)
    opt = optim_init(student)
    train_round(student, opt, agg, gen)  # the eager first step
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        train_round(student, opt, agg, gen)
    spans = sorted(((e.name(), e.start_ns(), e.end_ns())
                    for e in prof.profiler.kineto_results.events()
                    if e.name().startswith("raptor.")), key=lambda e: (e[1], -e[2]))
    assert [s[0] for s in spans] == ["raptor.distill.step", "raptor.distill.gather",
                                     "raptor.distill.graph", "raptor.distill.forward",
                                     "raptor.distill.backward", "raptor.distill.optimizer"]
    step, gather, graph, forward, backward, optimizer = spans
    assert gather[2] <= graph[1] and graph[2] <= optimizer[1] and optimizer[2] <= step[2]
    assert graph[1] <= forward[1] and backward[2] <= graph[2]


# ---------------------------------------------------------------------------
# the card: capture and replay against the eager path and the CPU trainer
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["constant", "scheduled_severe"])
def test_graph_replay_matches_the_eager_path_on_the_card(card, monkeypatch, case):
    """10 calls of one step each at the recipe's batch and length (64 x 500)
    from 256 sequences: the first eager, the second captures, the rest
    replay; the eager run takes the same optimizer's steps eagerly."""
    runs = {}
    for graphed in (False, True):
        cfg, agg, student, gen = trainer(card, case, t=500, cap=256, batch=64, seed=11)
        train_round, optim_init = pt.make_train_from_aggregate(cfg)
        opt = optim_init(student)
        rows = []
        with monkeypatch.context() as m:
            if not graphed:
                m.setattr(pt, "_graph_steps", lambda device: False)
            ops_bptt.launches = 0
            for _ in range(10):
                _, _, losses = train_round(student, opt, agg, gen)
                rows.append((losses, *snapshot(student, opt, gen)))
            torch.cuda.synchronize()
            assert ops_bptt.launches == 30  # a forward and a backward (two) a step
        runs[graphed] = rows
    losses = [float(r[0][0]) for r in runs[True]]
    assert len(set(losses)) == 10  # one loss a step, not the static buffer's last
    for (gl, gleaves, _, gstate), (el, eleaves, _, estate) in zip(runs[True], runs[False]):
        assert torch.equal(gstate, estate)
        assert abs(float(gl[0]) - float(el[0])) <= 1e-6 * abs(float(el[0]))
        for a, b in zip(gleaves, eleaves):
            assert float((a - b).norm()) <= 1e-6 * float(b.norm())


def card_against_cpu(card, steps=4, seed=13):
    """`steps` calls of the graphed `train_round` on the card (one step each,
    scheduled: the first eager, the second captures, the rest replay), and
    the CPU trainer (`make_optimizer` and `_grad_step`) from copies of the
    same weights over the same minibatches, drawn again from the card
    generator's state before each call. Returns the largest relative gap of
    a step's loss, and of a leaf's change: the gap between the norms of the
    card's and the CPU's change of the leaf, against the larger of the CPU
    change's norm and the median leaf's (Adam's first step takes each
    gradient entry's sign, so an entry's change is not smooth in the
    rounding; a leaf's norm is)."""
    cfg, agg, student, gen = trainer(card, "scheduled", t=500, cap=256, batch=64, seed=seed)
    w0 = {(layer, k): v.detach().cpu().double() for layer, d in student.items()
          for k, v in d.items()}
    cpu_student = {layer: {k: v.detach().cpu().clone().requires_grad_(True)
                           for k, v in d.items()} for layer, d in student.items()}
    cpu_agg = pt.Aggregate(agg.obs.cpu(), agg.teacher_action.cpu(), agg.reset.cpu(), agg.size)
    train_round, optim_init = pt.make_train_from_aggregate(cfg)
    opt, cpu_opt = optim_init(student), pt.make_optimizer(cfg)(cpu_student)
    loss_gap = 0.0
    for _ in range(steps):
        redraw = torch.Generator(device=card)
        redraw.set_state(gen.get_state())
        idx = torch.randint(0, agg.size, (cfg.batch_size,), generator=redraw, device=card)
        _, _, losses = train_round(student, opt, agg, gen)
        cpu_loss = pt._grad_step(cpu_student, cpu_opt, *pt._gather(cpu_agg, idx.cpu()), None,
                                 cfg)
        loss_gap = max(loss_gap, abs(float(losses[0]) - float(cpu_loss)) / float(cpu_loss))
    assert opt[1].last_epoch == cpu_opt[1].last_epoch == steps
    change = {(layer, k): float((v.detach().cpu().double() - w0[layer, k]).norm())
              for layer, d in student.items() for k, v in d.items()}
    cpu_change = {(layer, k): float((v.detach().double() - w0[layer, k]).norm())
                  for layer, d in cpu_student.items() for k, v in d.items()}
    median = statistics.median(cpu_change.values())
    change_gap = max(abs(change[k] - c) / max(c, median) for k, c in cpu_change.items())
    return loss_gap, change_gap


@pytest.mark.cuda
def test_graph_path_on_the_card_matches_the_cpu_trainer(card):
    """The card's optimizer against the CPU's over four scheduled steps at
    64 x 500. On an H100 the port's Adam reads a change gap of 3e-8 to 1e-7
    here (seeds 13, 21, 34); a capturable foreach Adam, whose bias
    corrections are taken in float32, 7.6e-6 to 7.8e-6; a capturable fused
    one 1.1e-6 to 1.5e-6."""
    loss_gap, change_gap = card_against_cpu(card)
    print(f"card against the CPU trainer: loss gap {loss_gap:.3g}, change gap {change_gap:.3g}")
    assert loss_gap <= 1e-5
    assert change_gap <= 5e-7


@pytest.mark.cuda
def test_one_capture_over_rounds_and_a_new_aggregate_captures_anew(card, monkeypatch):
    built = []

    class Counted(pt._StepGraph):
        def __init__(self, *args):
            built.append(1)
            super().__init__(*args)

    monkeypatch.setattr(pt, "_StepGraph", Counted)
    cfg, agg, student, gen = trainer(card, "scheduled", t=50, cap=64, batch=16, steps=4)
    train_round, optim_init = pt.make_train_from_aggregate(cfg)
    opt = optim_init(student)
    for _ in range(3):
        train_round(student, opt, agg, gen)
    assert len(built) == 1 and opt[1].last_epoch == 12
    assert all(p.grad is None for p in opt[0].param_groups[0]["params"])
    _, agg2, _, _ = trainer(card, "scheduled", t=50, cap=64, batch=16, steps=4, seed=6)
    _, _, losses = train_round(student, opt, agg2, gen)
    torch.cuda.synchronize()
    assert len(built) == 2 and bool(torch.isfinite(losses).all())
    assert float(opt[0].state[opt[0].param_groups[0]["params"][0]]["step"]) == 16
