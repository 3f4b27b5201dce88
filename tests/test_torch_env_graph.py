"""A fresh population's sampler and reset, split into draws and arithmetic,
with the arithmetic as a CUDA graph replay on a card (`utils.graphs`).

On the CPU everything stays eager. `sample_population` and `L2F.reset` must
equal, bit for bit, a straight-line copy of the formulas they had before the
split (kept below: every draw where its leaf is computed), and leave the
generator in the same state; the reset's graph body (`_reset_from_draws`,
which sees only the airframes' `RESET_READS`) must equal the eager reset;
two calls share no storage; the tally counts eager calls only. The graph
cache's routing (first call eager, second captures, then replays; a new key
eager; a bounded cache; tensors keyed by identity) is held with a stand-in
for the capture, and the draws (`rand`, `randn`, `randint` with a bound of
the call's own) fresh and into static buffers alike.

The tests marked `cuda` capture and replay on the card, against the eager
path and the straight-line copy. The file imports neither JAX nor the JAX
package:

    python -m pytest --noconftest -m cuda tests/test_torch_env_graph.py -q
"""

import dataclasses
import math
import weakref

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from raptor_tpu_torch.env import L2F, EnvConfig, InitConfig, ObservationConfig, State
from raptor_tpu_torch.env import dynamics, presets, quad
from raptor_tpu_torch.env import randomization as rnd
from raptor_tpu_torch.env.randomization import RandomizationConfig, sample_population
from raptor_tpu_torch.env.types import DynamicsParams, tree_map
from raptor_tpu_torch.utils import graphs

# ---------------------------------------------------------------------------
# the formulas before the split, straight-line: each draw where it is used
# ---------------------------------------------------------------------------


def _uniform(g, shape, lo, hi):
    return lo + torch.rand(shape, generator=g, device=g.device) * (hi - lo)


def _log_uniform(g, shape, lo, hi):
    return torch.exp(_uniform(g, shape, math.log(lo), math.log(hi)))


def straight_population(g, n, c=RandomizationConfig()):
    mass = _log_uniform(g, (n,), c.mass_min, c.mass_max)
    normal = torch.randn((n,), generator=g, device=g.device)
    arm = 0.046 * (mass / 0.027) ** (1.0 / 3.0) * torch.exp(normal * c.arm_length_rel_std * 0.5)
    j_factor = _uniform(g, (n,), c.j_factor_min, c.j_factor_max)
    jz_ratio = _uniform(g, (n,), c.jz_ratio_min, c.jz_ratio_max)
    j_xy = j_factor * mass * arm**2
    inertia = torch.stack([j_xy, j_xy, jz_ratio * j_xy], -1)
    t2w = _uniform(g, (n,), c.thrust_to_weight_min, c.thrust_to_weight_max)
    kappa = _uniform(g, (n,), c.torque_constant_rel_min, c.torque_constant_rel_max) * arm
    t_m = _log_uniform(g, (n,), c.motor_time_constant_min, c.motor_time_constant_max)
    rpm_min = _uniform(g, (n,), c.rpm_min_min, c.rpm_min_max)
    base_pos = torch.as_tensor(presets.x_config_rotor_positions(1.0), device=g.device)
    jitter = torch.randn((n, 4, 3), generator=g, device=g.device) * c.rotor_position_jitter
    rotor_positions = (base_pos + jitter) * arm[:, None, None]
    tilt = torch.randn((n, 4, 2), generator=g, device=g.device) * c.thrust_axis_tilt_std
    thrust_dirs = torch.stack([
        torch.sin(tilt[..., 0]),
        torch.sin(tilt[..., 1]) * torch.cos(tilt[..., 0]),
        torch.cos(tilt[..., 1]) * torch.cos(tilt[..., 0]),
    ], -1)
    a_mix = _uniform(g, (n,), 0.0, c.thrust_curve_linear_mix_max)
    t_max_rotor = t2w * mass * presets.GRAVITY / 4.0
    thrust_curve = torch.stack(
        [torch.zeros_like(a_mix), a_mix * t_max_rotor, (1.0 - a_mix) * t_max_rotor], -1)

    def full(v):
        return torch.full((n,), v, dtype=torch.float32, device=g.device)

    return DynamicsParams(
        mass=mass, inertia_diag=inertia, inertia_diag_inv=1.0 / inertia,
        rotor_positions=rotor_positions, rotor_thrust_directions=thrust_dirs,
        rotor_torque_signs=torch.as_tensor(presets.ROTOR_TORQUE_SIGNS, device=g.device)
        .expand(n, 4).contiguous(),
        thrust_curve=thrust_curve, torque_constant=kappa, rpm_min=rpm_min, rpm_max=full(1.0),
        motor_time_constant=t_m, disturbance_force_std=full(c.disturbance_force_std),
        disturbance_torque_std=full(c.disturbance_torque_std))


def straight_reset(env, params, g):
    """(state, action history, angular velocity history, t, observation)."""
    c, n, dev = env.config.init, params.mass.shape[0], g.device
    position = -c.position_range + torch.rand((n, 3), generator=g, device=dev) * (
        2.0 * c.position_range)
    axis = torch.randn((n, 3), generator=g, device=dev)
    axis = axis * torch.rsqrt(torch.sum(axis * axis, -1, keepdim=True) + 1e-12)
    u = torch.rand((n,), generator=g, device=dev)
    if c.angle_power != 1.0:
        u = u ** (1.0 / c.angle_power)
    half = 0.5 * (u * c.max_angle)
    orientation = torch.cat([torch.cos(half)[..., None], torch.sin(half)[..., None] * axis], -1)
    linear_velocity = torch.randn((n, 3), generator=g, device=dev) * c.linear_velocity_std
    angular_velocity = torch.randn((n, 3), generator=g, device=dev) * c.angular_velocity_std
    rpm = dynamics.hover_rpm(params) if c.rpm_at_hover else params.rpm_min
    state = State(position, orientation, linear_velocity, angular_velocity,
                  rpm[:, None].expand(n, 4).contiguous())
    h = env.config.observation.action_history_length
    d = env.config.observation.angular_velocity_delay
    action_history = state.position.new_zeros((n, h, 4))
    angvel_history = state.angular_velocity[:, None].expand(n, d + 1, 3).contiguous()
    t = torch.zeros(n, dtype=torch.int32, device=dev)
    return state, action_history, angvel_history, t, env.observe(
        params, state, action_history, angvel_history)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def make_env(privileged=True, rpm_at_hover=True, h=1, d=0, angle_power=1.0):
    return L2F(EnvConfig(
        init=InitConfig(max_angle=1.0, angle_power=angle_power, rpm_at_hover=rpm_at_hover),
        observation=ObservationConfig(action_history_length=h, angular_velocity_delay=d,
                                      privileged=privileged)))


def leaves_of(tree):
    if dataclasses.is_dataclass(tree):
        return [x for f in dataclasses.fields(tree) for x in leaves_of(getattr(tree, f.name))]
    if isinstance(tree, (tuple, list)):
        return [x for item in tree for x in leaves_of(item)]
    return [tree]


def reset_leaves(es, obs):
    return leaves_of((es.dynamics, es.action_history, es.angvel_history, es.t, obs))


def assert_bitwise(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape and a.device == b.device
        assert torch.equal(a, b)


def generator(device, seed):
    return torch.Generator(device=device).manual_seed(seed)


def forget_graphs():
    """Empty both caches and zero the tally."""
    rnd._GRAPHED.clear()
    quad._GRAPHED.clear()
    for row in graphs.calls.values():
        for k in row:
            row[k] = 0


# ---------------------------------------------------------------------------
# the CPU: the split equals the formulas before it
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [3, 2**31 + 7])
@pytest.mark.parametrize("n", [1, 256])
def test_population_equals_the_straight_line_formulas(seed, n):
    g, want_g = generator("cpu", seed), generator("cpu", seed)
    got = sample_population(g, n)
    want = straight_population(want_g, n)
    assert_bitwise(leaves_of(got), leaves_of(want))
    assert all(x.is_contiguous() for x in leaves_of(got))
    assert torch.equal(g.get_state(), want_g.get_state())


@pytest.mark.parametrize("seed", [5, 2**31 + 11])
@pytest.mark.parametrize("n", [3, 256])
@pytest.mark.parametrize("privileged", [True, False])
@pytest.mark.parametrize("rpm_at_hover", [True, False])
def test_reset_equals_the_straight_line_formulas(seed, n, privileged, rpm_at_hover):
    """`reset`, the step's eager `_reset` and the graph's body run eagerly,
    against the formulas before the split, on one population."""
    env = make_env(privileged, rpm_at_hover)
    params = sample_population(generator("cpu", seed + 1), n)
    want_g = generator("cpu", seed)
    want = leaves_of(straight_reset(env, params, want_g))
    for run in ("reset", "_reset", "body"):
        g = generator("cpu", seed)
        if run == "body":
            draws = graphs.draw(g, quad.state_draws(n))
            got = env._reset_from_draws(draws, [getattr(params, k) for k in quad.RESET_READS])
            got = reset_leaves(*quad._as_reset(got))
        else:
            got = reset_leaves(*getattr(env, run)(params, g))
        assert_bitwise(got, want)
        assert torch.equal(g.get_state(), want_g.get_state())
    assert want[-1].shape == (n, 31 if privileged else 22)


def test_histories_and_angle_power_follow_the_config():
    env = make_env(h=3, d=2, angle_power=2.0)
    params = sample_population(generator("cpu", 1), 17)
    got = reset_leaves(*env.reset(params, generator("cpu", 2)))
    assert_bitwise(got, leaves_of(straight_reset(env, params, generator("cpu", 2))))
    assert got[5].shape == (17, 3, 4) and got[6].shape == (17, 3, 3)


def test_sample_state_draws_what_reset_draws():
    env = make_env()
    params = sample_population(generator("cpu", 1), 9)
    g1, g2 = generator("cpu", 4), generator("cpu", 4)
    state = env.sample_state(params, g1)
    es, _ = env.reset(params, g2)
    assert_bitwise(leaves_of(state), leaves_of(es.dynamics))
    assert torch.equal(g1.get_state(), g2.get_state())


def test_the_reset_body_reads_only_its_leaves():
    """The graph's body sees None for every leaf outside `RESET_READS`; a
    body that read one would fail here, before any capture."""
    env = make_env()
    params = sample_population(generator("cpu", 1), 4)
    draws = graphs.draw(generator("cpu", 2), quad.state_draws(4))
    leaves = [getattr(params, k) for k in quad.RESET_READS]
    env._reset_from_draws(draws, leaves)
    with pytest.raises((AttributeError, TypeError)):
        env._reset_from_draws(draws, leaves[:-1])  # rotor_positions left out


def test_two_calls_share_no_storage():
    env = make_env()
    g = generator("cpu", 6)
    calls = [(sample_population(g, 8), *env.reset(sample_population(g, 8), g)) for _ in range(2)]
    first = {x.untyped_storage().data_ptr() for x in leaves_of(calls[0])}
    second = {x.untyped_storage().data_ptr() for x in leaves_of(calls[1])}
    assert not first & second


def test_the_cpu_counts_eager_calls_only():
    forget_graphs()
    env, g = make_env(), generator("cpu", 7)
    for _ in range(3):
        env.reset(sample_population(g, 16), g)
    env.step(sample_population(g, 16), env.reset(sample_population(g, 16), g)[0],
             torch.zeros(16, 4), g)  # the auto-reset is not counted
    assert graphs.calls["sample_population"] == {"eager": 5, "capture": 0, "replay": 0}
    assert graphs.calls["reset"] == {"eager": 4, "capture": 0, "replay": 0}
    assert graphs.replay_share() == 0.0


def test_a_subclass_with_its_own_states_is_never_keyed(monkeypatch):
    """Its own `sample_state` cannot be keyed: `reset` takes the eager
    `_reset` and never reaches the graph path."""
    class Handed(L2F):
        def sample_state(self, params, generator):
            return self.states

    env = Handed(EnvConfig())
    params = sample_population(generator("cpu", 1), 5)
    env.states = L2F(EnvConfig()).sample_state(params, generator("cpu", 2))
    keys = []
    monkeypatch.setattr(quad, "_GRAPHED", lambda key, *a: keys.append(key))
    es, _ = env.reset(params, generator("cpu", 3))
    assert keys == [] and es.dynamics.position is env.states.position


class FakeGraph:
    built = []

    def __init__(self, device, generator, specs, body, inputs):
        FakeGraph.built.append(device)
        self.loads = 1

    def load(self, generator, specs, inputs):
        self.loads += 1

    def replay(self):
        return ["replay"]


def test_routing_first_eager_then_capture_then_replay(monkeypatch):
    """The cache's routing with a stand-in for the capture and a generator
    that names a card: a key's first call eager, its second captures, later
    calls replay; a new key eager; a capture in progress or an input of
    another dtype eager; the oldest key goes beyond `ENTRIES`."""
    monkeypatch.setattr(graphs, "_Graph", FakeGraph)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    capturing = [False]
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing[0])
    FakeGraph.built = []

    class CardGenerator:
        device = torch.device("cuda")  # no index: the current device's

    cached = graphs.Graphed("routing_probe")
    try:
        def call(key, inputs=()):
            return cached(key, CardGenerator(), (), lambda draws, inputs: ["eager"], inputs)[0]

        assert [call("a") for _ in range(4)] == ["eager", "replay", "replay", "replay"]
        assert FakeGraph.built == [torch.device("cuda", 0)]
        assert graphs.calls["routing_probe"] == {"eager": 1, "capture": 1, "replay": 2}
        assert graphs.replay_share("routing_probe") == 0.5
        capturing[0] = True
        assert call("a") == "eager"
        capturing[0] = False
        assert call("b", [torch.zeros(2, dtype=torch.float64)]) == "eager"
        assert graphs.ENTRIES == 4
        assert [call(k) for k in "bcd"] == ["eager"] * 3  # first calls; a is the oldest
        assert call("e") == "eager"  # e's first call; a goes
        assert call("a") == "eager" and call("a") == "replay"  # a's first and second again
        assert len(FakeGraph.built) == 2
    finally:
        del graphs.calls["routing_probe"]


def test_a_key_names_tensors_by_identity(monkeypatch):
    """`Identity` in a key: the same tensor objects are the same key, equal
    values in other tensors a new one; a cached key keeps its tensors
    alive."""
    monkeypatch.setattr(graphs, "_Graph", FakeGraph)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)

    class CardGenerator:
        device = torch.device("cuda", 0)

    cached = graphs.Graphed("identity_probe")
    try:
        def call(*tensors):
            key = ("config", graphs.Identity(*tensors))
            return cached(key, CardGenerator(), (), lambda draws, inputs: ["eager"])[0]

        a, b = torch.zeros(3), torch.ones(2)
        assert [call(a, b), call(a, b), call(a, b)] == ["eager", "replay", "replay"]
        assert call(a.clone(), b) == "eager" and call(b, a) == "eager"
        assert graphs.Identity(a, b) == graphs.Identity(a, b) != graphs.Identity(a, b.clone())
        assert hash(graphs.Identity(a, b)) == hash(graphs.Identity(a, b))
        watched = weakref.ref(a)
        del a
        assert watched() is not None  # held by the cached keys
        cached.clear()
        assert watched() is None
    finally:
        del graphs.calls["identity_probe"]


@pytest.mark.parametrize("kind", ["rand", "randn", "randint"])
def test_draws_fresh_and_into_static_buffers_are_equal(kind):
    """`draw` makes the same numbers fresh or into buffers, and leaves the
    generator in the same state; `randint`'s bound is the spec's own."""
    specs = [(kind, (5, 3), 11), (kind, (7,), 1000)] if kind == "randint" else [
        (kind, (5, 3)), (kind, (7,))]
    dtype = torch.int64 if kind == "randint" else torch.float32
    g, buffered_g = generator("cpu", 21), generator("cpu", 21)
    fresh = graphs.draw(g, specs)
    out = [torch.empty(shape, dtype=dtype) for _, shape, *_ in specs]
    buffered = graphs.draw(buffered_g, specs, out)
    assert all(x is o for x, o in zip(buffered, out))
    assert_bitwise(buffered, fresh)
    assert torch.equal(g.get_state(), buffered_g.get_state())
    if kind == "randint":
        assert int(fresh[0].max()) < 11 and int(fresh[1].max()) >= 11


# ---------------------------------------------------------------------------
# the card: capture and replay against the eager path
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def eager_population(dev, seed, n):
    g = generator(dev, seed)
    leaves = rnd._population_from_draws(graphs.draw(g, rnd.population_draws(n)),
                                        RandomizationConfig())
    return leaves, g.get_state()


def harness_inputs(dev, seed, n_air=2048, per=8):
    """A population repeated over its envs, as the evaluation harness makes it."""
    frames = sample_population(generator(dev, seed), n_air)
    return tree_map(lambda x: x.repeat_interleave(per, 0), frames)


SEEDS = [3000000001, 3000000002, 2**31 + 5, 17, 4000000009]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [37, 2048])
def test_population_replay_equals_eager_on_the_card(card, n):
    """5 calls with one key, each on its own seed: eager, capture, 3 replays;
    each equal to the eager path and to the straight-line formulas, with the
    generator left in the same state."""
    forget_graphs()
    for seed in SEEDS:
        g = generator(card, seed)
        got = leaves_of(sample_population(g, n))
        want, state = eager_population(card, seed, n)
        assert_bitwise(got, want)
        assert_bitwise(got, leaves_of(straight_population(generator(card, seed), n)))
        assert torch.equal(g.get_state(), state)
    assert graphs.calls["sample_population"] == {"eager": 1, "capture": 1, "replay": 3}


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["harness", "small_unprivileged", "small_histories"])
def test_reset_replay_equals_eager_on_the_card(card, case):
    """5 calls with one key, on the harness's 16,384 envs or 37 envs with
    other configs: eager, capture, 3 replays, each equal (states, histories,
    t and observation) to the eager `_reset`, with the generator in the
    same state."""
    env = {"harness": make_env(), "small_unprivileged": make_env(False, False),
           "small_histories": make_env(h=3, d=2, angle_power=2.0)}[case]
    forget_graphs()
    for i, seed in enumerate(SEEDS):
        params = (harness_inputs(card, seed + 1) if case == "harness"
                  else sample_population(generator(card, seed + 1), 37))
        g, eager_g = generator(card, seed), generator(card, seed)
        got = reset_leaves(*env.reset(params, g))
        assert_bitwise(got, reset_leaves(*env._reset(params, eager_g)))
        assert_bitwise(got, leaves_of(straight_reset(env, params, generator(card, seed))))
        assert torch.equal(g.get_state(), eager_g.get_state())
    assert graphs.calls["reset"] == {"eager": 1, "capture": 1, "replay": 3}


@pytest.mark.cuda
def test_later_calls_leave_earlier_results_alone(card):
    forget_graphs()
    env, kept = make_env(), []
    for seed in SEEDS[:4]:
        params = sample_population(generator(card, seed), 300)
        es, obs = env.reset(params, generator(card, seed + 1))
        leaves = leaves_of(params) + reset_leaves(es, obs)
        kept.append((leaves, [x.clone() for x in leaves]))
    torch.cuda.synchronize()
    for leaves, copies in kept:
        assert_bitwise(leaves, copies)
    assert graphs.calls["reset"]["replay"] == 2 and graphs.calls["sample_population"]["replay"] == 2


@pytest.mark.cuda
def test_a_new_size_takes_a_new_key(card):
    forget_graphs()
    for n in (64, 64, 64, 65, 65, 64):
        sample_population(generator(card, n), n)
    assert graphs.calls["sample_population"] == {"eager": 2, "capture": 2, "replay": 2}
    got = leaves_of(sample_population(generator(card, 9), 65))
    assert_bitwise(got, eager_population(card, 9, 65)[0])


@pytest.mark.cuda
def test_the_step_auto_reset_never_replays(card, monkeypatch):
    forget_graphs()
    env = make_env()
    params = sample_population(generator(card, 1), 128)
    g = generator(card, 2)
    es, _ = env.reset(params, g)
    replays = []
    monkeypatch.setattr(graphs._Graph, "replay", lambda self: replays.append(1))
    for _ in range(5):
        es, *_ = env.step(params, es, torch.zeros((128, 4), device=card), g)
    assert replays == [] and graphs.calls["reset"] == {"eager": 1, "capture": 0, "replay": 0}


@pytest.mark.cuda
def test_results_are_equal_under_a_profiler(card):
    """Eager, capture and replays with the card traced: the same numbers,
    and the replay's kernels in the trace."""
    env = make_env()
    forget_graphs()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for seed in SEEDS[:4]:
            params = sample_population(generator(card, seed), 256)
            got = reset_leaves(*env.reset(params, generator(card, seed + 1)))
            assert_bitwise(leaves_of(params), eager_population(card, seed, 256)[0])
            assert_bitwise(got, reset_leaves(*env._reset(params, generator(card, seed + 1))))
        torch.cuda.synchronize()
    assert graphs.calls["reset"] == {"eager": 1, "capture": 1, "replay": 2}
    names = [e.key for e in prof.key_averages()]
    assert any(n.startswith("raptor.env.reset") for n in names)
