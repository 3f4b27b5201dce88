"""The distillation step on the port's graph mechanism (`utils.graphs`),
held to the eager step as it was written before the graph.

Without a process group `train_round` takes each step's loss and gradients
from one `Graphed("distill.step")` call: the draw of the minibatch's columns
(`("randint", (batch,), agg.size)`), then `_gather` and `_loss_and_grad` as
its body; `_grad_step` steps Adam on them. On the CPU the call is eager. The
body run from an index drawn into a static buffer, as a replay takes it, and
`train_round` itself must match a straight-line eager step (draw, gather,
`bptt_loss`, `.backward()`, Adam) bit for bit: losses, leaves, Adam's moments
and the minibatch generator's state after every step. The key: a new
aggregate or normalizer is a new key, a new `agg.size` or a new optimizer is
not. The process group and `make_train_epoch` never enter the graph path. A
capture launches nothing; a replay counts what it captured (held on the CPU
with a stand-in for the CUDA graph).

The tests marked `cuda` capture and replay on the card: against the
straight-line step for 10 steps from the same weights and generator, against
the CPU trainer (whose Adam the JAX package's optax holds in
`test_torch_distill.py`) over the same minibatches at the recipe's size, and
the launch tally of a capture and a replay. The file imports neither JAX nor
the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_distill_graph.py -q
"""

import contextlib
import statistics

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from raptor_tpu_torch.distill import post_training as pt
from raptor_tpu_torch.policy import network
from raptor_tpu_torch.utils import graphs
from raptor_tpu_torch.utils.profiling import launches

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


def straight_step(student, opt, agg, gen, cfg):
    """One step as the eager path took it before the graph: the draw, the
    gather, `bptt_loss`, `.backward()` onto the leaves, Adam, the schedule."""
    idx = torch.randint(0, max(agg.size, 1), (cfg.batch_size,), generator=gen,
                        device=agg.obs.device)
    obs, lab, rst = (agg.obs[:, idx].float(), agg.teacher_action[:, idx].float(),
                     agg.reset[:, idx].float())
    loss = pt.bptt_loss(student, obs, lab, rst, None, cfg.severe_weight, cfg.severe_tilt)
    loss.backward()
    opt[0].step()
    opt[1].step()
    opt[0].zero_grad(set_to_none=True)
    return loss.detach()


def assert_same(rows, want):
    for (losses, leaves, moments, state), (wlosses, wleaves, wmoments, wstate) in zip(rows, want):
        assert torch.equal(losses, wlosses) and torch.equal(state, wstate)
        for a, b in zip(leaves + moments, wleaves + wmoments):
            assert torch.equal(a, b)


def step_keys(monkeypatch):
    """The keys of every `Graphed` call from here on, in order."""
    keys = []
    original = graphs.Graphed.__call__

    def recording(self, key, *args, **kw):
        keys.append(key)
        return original(self, key, *args, **kw)

    monkeypatch.setattr(graphs.Graphed, "__call__", recording)
    return keys


# ---------------------------------------------------------------------------
# CPU: the body and the eager path against the straight-line step; the key
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", list(CASES))
def test_static_buffer_step_is_the_eager_step_bit_for_bit(case):
    """The body on a minibatch index drawn into a static int64 buffer, as a
    replay takes it, then `_grad_step`: three steps, each equal to the
    straight-line eager step."""
    cfg, agg, student, gen = trainer("cpu", case)
    opt = pt.make_optimizer(cfg)(student)
    ecfg, eagg, estudent, egen = trainer("cpu", case)
    eopt = pt.make_optimizer(ecfg)(estudent)
    specs = (("randint", (cfg.batch_size,), agg.size),)
    idx = [torch.zeros(cfg.batch_size, dtype=torch.int64)]
    for _ in range(3):
        (drawn,) = graphs.draw(gen, specs, idx)
        assert drawn is idx[0]
        loss, grads = pt._loss_and_grad(student, *pt._gather(agg, idx[0]), None, cfg)
        loss = pt._grad_step(student, opt, loss, grads)
        eloss = straight_step(estudent, eopt, eagg, egen, ecfg)
        assert torch.equal(loss, eloss)
        assert_same([(loss, *snapshot(student, opt, gen))],
                     [(eloss, *snapshot(estudent, eopt, egen))])
        assert all(p.grad is None for p in opt[0].param_groups[0]["params"])
    assert opt[1].last_epoch == eopt[1].last_epoch == 3
    assert opt[0].param_groups[0]["lr"] == eopt[0].param_groups[0]["lr"]


@pytest.mark.parametrize("case", ["constant_severe", "scheduled"])
def test_train_round_through_the_graph_path_matches_the_eager_round(case):
    """Two rounds of three steps through `train_round` (one `Graphed` call
    each, eager on the CPU) against the straight-line steps."""
    cfg, agg, student, gen = trainer("cpu", case, steps=3)
    train_round, optim_init = pt.make_train_from_aggregate(cfg)
    opt = optim_init(student)
    ecfg, eagg, estudent, egen = trainer("cpu", case, steps=3)
    eopt = pt.make_optimizer(ecfg)(estudent)
    rows, want = [], []
    for _ in range(2):
        _, _, losses = train_round(student, opt, agg, gen)
        rows.append((losses, *snapshot(student, opt, gen)))
        elosses = torch.stack([straight_step(estudent, eopt, eagg, egen, ecfg)
                               for _ in range(3)])
        want.append((elosses, *snapshot(estudent, eopt, egen)))
    assert_same(rows, want)


def test_process_group_and_epoch_trainer_take_the_eager_step(monkeypatch):
    """No group: one `Graphed` call a step, then `_grad_step`. A group (a
    stand-in the stand-in steps never use) and `make_train_epoch`: no
    `Graphed` call, the group handed to both halves of the step."""
    cfg, agg, student, gen = trainer("cpu", "scheduled", steps=2)
    keys = step_keys(monkeypatch)
    calls = []

    def loss_and_grad(student_params, obs, lab, rst, norm, cfg_, group=None):
        calls.append(("loss", group))
        return torch.zeros(()), [torch.zeros_like(p) for p in pt._leaves(student_params)]

    def grad_step(student_params, opt_, loss, grads, group=None):
        calls.append(("step", group))
        return loss

    monkeypatch.setattr(pt, "_loss_and_grad", loss_and_grad)
    monkeypatch.setattr(pt, "_grad_step", grad_step)
    train_round, optim_init = pt.make_train_from_aggregate(cfg)
    opt = optim_init(student)
    _, _, losses = train_round(student, opt, agg, gen)
    assert len(keys) == 2 and keys[0] == keys[1] and losses.shape == (2,)
    assert calls == [("loss", None), ("step", None)] * 2
    keys.clear()
    calls.clear()
    group = object()
    grouped, _ = pt.make_train_from_aggregate(cfg, group)
    _, _, losses = grouped(student, opt, agg, gen)
    assert keys == [] and calls == [("loss", group), ("step", group)] * 2
    assert losses.shape == (2,)

    train_epoch, epoch_init = pt.make_train_epoch(cfg)
    data = pt.RoundData(agg.obs.float(), agg.teacher_action.float(), agg.reset.float())
    calls.clear()
    _, _, losses = train_epoch(student, epoch_init(student), data, gen)
    assert keys == [] and calls == [("loss", None), ("step", None)] * 3  # 12 sequences, by 4
    assert losses.shape == (3,)


def test_a_new_aggregate_or_normalizer_takes_a_new_key_and_a_new_optimizer_none(monkeypatch):
    keys = step_keys(monkeypatch)
    cfg, agg, student, gen = trainer("cpu", "scheduled", steps=1)
    train_round, optim_init = pt.make_train_from_aggregate(cfg)
    opt = optim_init(student)
    train_round(student, opt, agg, gen)
    train_round(student, opt, agg, gen)
    _, agg2, _, _ = trainer("cpu", "scheduled", steps=1)
    train_round(student, opt, agg2, gen)
    train_round(student, optim_init(student), agg2, gen)  # a new optimizer: the same key
    norm = pt.identity_norm("cpu")
    train_round(student, opt, agg2, gen, norm)
    agg2.size = 5  # the filled prefix is the draw's bound, not in the key
    train_round(student, opt, agg2, gen, norm)
    train_round(student, opt, agg2, gen, pt.identity_norm("cpu"))
    assert [sum(k == other for other in keys[:i]) > 0 for i, k in enumerate(keys)] == [
        False, True, False, True, False, True, False]
    assert hash(keys[0]) == hash(keys[1]) and keys[0][0] is cfg


def test_a_capture_launches_nothing_and_a_replay_what_it_captured(monkeypatch):
    """The tally rule of `utils.graphs._Graph` on the CPU, with a stand-in
    for the CUDA graph and a body that counts three BPTT launches, as B5's
    forward and backward do: the capture adds none, each replay three; the
    draw goes into a static int64 buffer and a replay's outputs are a clone
    of the arena."""

    class StandIn:
        def replay(self):
            pass

    monkeypatch.setattr(torch.cuda, "CUDAGraph", StandIn)
    monkeypatch.setattr(torch.cuda, "graph", lambda graph: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())

    def body(draws, inputs):
        launches["bptt"] += 3
        return [draws[0].float().sum(), inputs[0] * 2.0]

    gen, specs = torch.Generator().manual_seed(3), (("randint", (4,), 7),)
    before = launches["bptt"]
    graph = graphs._Graph(torch.device("cpu"), gen, specs, body, [torch.ones(2)])
    assert launches["bptt"] == before and graph.launches == {"bptt": 3}
    assert graph.draws[0].dtype == torch.int64 and int(graph.draws[0].max()) < 7
    for i in range(3):
        graph.load(gen, specs, [torch.full((2,), float(i))])
        total, doubled = graph.replay()
        assert launches["bptt"] == before + 3 * (i + 1)
        assert total.shape == () and doubled.shape == (2,)
        assert doubled.untyped_storage().data_ptr() != graph.arena.untyped_storage().data_ptr()
    assert torch.equal(graph.inputs, torch.full((2,), 2.0))


def test_graph_step_spans_nest_in_order():
    """On the CPU the step holds the gather, forward, backward and
    optimizer spans, in order (a replay on a card enters none of the first
    three); the draw comes before the gather, inside the step."""
    cfg, agg, student, gen = trainer("cpu", "constant")
    train_round, optim_init = pt.make_train_from_aggregate(cfg)
    opt = optim_init(student)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        train_round(student, opt, agg, gen)
    events = sorted(((e.name(), e.start_ns(), e.end_ns())
                     for e in prof.profiler.kineto_results.events()),
                    key=lambda e: (e[1], -e[2]))
    spans = [e for e in events if e[0].startswith("raptor.")]
    assert [s[0] for s in spans] == ["raptor.distill.step", "raptor.distill.gather",
                                     "raptor.distill.forward", "raptor.distill.backward",
                                     "raptor.distill.optimizer"]
    step, gather, forward, backward, optimizer = spans
    assert gather[2] <= forward[1] and forward[2] <= backward[1]
    assert backward[2] <= optimizer[1] and optimizer[2] <= step[2]
    draws = [e for e in events if e[0] == "aten::randint" and step[1] <= e[1] <= gather[1]]
    assert len(draws) == 1


# ---------------------------------------------------------------------------
# the card: capture and replay against the straight-line step and the CPU
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
def test_graph_replay_matches_the_eager_path_on_the_card(card, case):
    """10 calls of one step each at the recipe's batch and length (64 x 500)
    from 256 sequences: the first eager, the second captures, the rest
    replay; the eager run takes the straight-line steps with the same
    optimizer."""
    runs = {}
    for graphed in (False, True):
        cfg, agg, student, gen = trainer(card, case, t=500, cap=256, batch=64, seed=11)
        train_round, optim_init = pt.make_train_from_aggregate(cfg)
        opt = optim_init(student)
        rows = []
        before = launches["bptt"]
        for _ in range(10):
            if graphed:
                _, _, losses = train_round(student, opt, agg, gen)
            else:
                losses = straight_step(student, opt, agg, gen, cfg)[None]
            rows.append((losses, *snapshot(student, opt, gen)))
        torch.cuda.synchronize()
        assert launches["bptt"] - before == 30  # a forward and a backward (two) a step
        runs[graphed] = rows
    losses = [float(r[0][0]) for r in runs[True]]
    assert len(set(losses)) == 10  # one loss a step, not the arena's last
    for (gl, gleaves, _, gstate), (el, eleaves, _, estate) in zip(runs[True], runs[False]):
        assert torch.equal(gstate, estate)
        assert abs(float(gl[0]) - float(el[0])) <= 1e-6 * abs(float(el[0]))
        for a, b in zip(gleaves, eleaves):
            assert float((a - b).norm()) <= 1e-6 * float(b.norm())


def card_against_cpu(card, steps=4, seed=13):
    """`steps` calls of the graphed `train_round` on the card (one step each,
    scheduled: the first eager, the second captures, the rest replay), and
    the CPU trainer (`make_optimizer`, `_loss_and_grad` and `_grad_step`)
    from copies of the same weights over the same minibatches, drawn again
    from the card generator's state before each call. Returns the largest
    relative gap of a step's loss, and of a leaf's change: the gap between
    the norms of the card's and the CPU's change of the leaf, against the
    larger of the CPU change's norm and the median leaf's (Adam's first step
    takes each gradient entry's sign, so an entry's change is not smooth in
    the rounding; a leaf's norm is)."""
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
        cpu_loss = pt._grad_step(cpu_student, cpu_opt, *pt._loss_and_grad(
            cpu_student, *pt._gather(cpu_agg, idx.cpu()), None, cfg))
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
def test_one_capture_over_rounds_and_a_new_aggregate_captures_anew(card):
    cfg, agg, student, gen = trainer(card, "scheduled", t=50, cap=64, batch=16, steps=4)
    train_round, optim_init = pt.make_train_from_aggregate(cfg)
    opt = optim_init(student)
    row = graphs.calls["distill.step"]
    start = dict(row)
    for _ in range(3):
        train_round(student, opt, agg, gen)
    assert {k: row[k] - start[k] for k in row} == {"eager": 1, "capture": 1, "replay": 10}
    assert opt[1].last_epoch == 12
    assert all(p.grad is None for p in opt[0].param_groups[0]["params"])
    _, agg2, _, _ = trainer(card, "scheduled", t=50, cap=64, batch=16, steps=4, seed=6)
    _, _, losses = train_round(student, opt, agg2, gen)
    torch.cuda.synchronize()
    assert {k: row[k] - start[k] for k in row} == {"eager": 2, "capture": 2, "replay": 12}
    assert bool(torch.isfinite(losses).all())
    assert float(opt[0].state[opt[0].param_groups[0]["params"][0]]["step"]) == 16


@pytest.mark.cuda
def test_a_replayed_step_adds_three_launches_and_a_capture_none(card, monkeypatch):
    """B5's forward and backward (3 launches) a step, counted in the tally
    by every step: eager, the capture's own replay and each later replay;
    the capture itself adds none."""
    captured = []
    original = graphs._Graph.__init__

    def counted_capture(self, *args):
        before = launches["bptt"]
        original(self, *args)
        captured.append(launches["bptt"] - before)

    monkeypatch.setattr(graphs._Graph, "__init__", counted_capture)
    cfg, agg, student, gen = trainer(card, "constant", t=50, cap=64, batch=16, steps=1)
    train_round, optim_init = pt.make_train_from_aggregate(cfg)
    opt = optim_init(student)
    added = []
    for _ in range(5):
        before = launches["bptt"]
        train_round(student, opt, agg, gen)
        added.append(launches["bptt"] - before)
    torch.cuda.synchronize()
    assert captured == [0] and added == [3] * 5
