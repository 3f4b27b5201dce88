"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test carries the `cuda` marker and skips where torch sees no CUDA
device. The file imports neither JAX nor the JAX package, so it also runs
where only PyTorch is installed (the JAX-importing tests/conftest.py is then
left out):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances are chip_smoke.py's: rollout atol 2e-4 / rtol 1e-3 over 20 steps
with termination off; eval alive and length equal on >= 99.9 % of envs, and
on those return within 5e-3 / 1e-3 and position within 1e-3, over 25 steps;
collect reset masks equal and observations within 2e-4 over 20 steps without
resets, reset masks equal on >= 99.9 % of entries under truncation, and
observations within 1e-5 where every row is a fresh draw of the in-kernel
PRNG; the same at widths that are no multiple of the warp size (37, and the
944 and 5,528 envs of a distillation round and of the 691-teacher union).
The three kernels fly an env on a team of lanes (the eval kernel several
envs on one team): they are held at those env
counts (and the rollout and eval kernels at 16,384: ragged teams and warps),
the eval kernel at every hidden width it is built for, the collect kernel at
widths 32 and 48 (48: the most registers and shared memory), with students
whose biases and h0 are drawn too; the eval kernel also where the envs of a
team end at different steps, and where its GRU gates leave the range of
their branch-free reciprocal.
"""

import re
from pathlib import Path

import pytest
import torch

from raptor_tpu_torch.checkpoint import from_numpy, h5
from raptor_tpu_torch.env import EnvConfig, InitConfig, L2F, TerminationConfig
from raptor_tpu_torch.env.randomization import sample_population
from raptor_tpu_torch.env.types import DynamicsParams
from raptor_tpu_torch.ops import collect as ops_collect
from raptor_tpu_torch.ops import eval as ops_eval
from raptor_tpu_torch.ops import rollout as ops_rollout
from raptor_tpu_torch.policy import network
from raptor_tpu_torch.utils.profiling import launches

N = 4096
NPZ = "raptor_tpu_torch/data/student_rateFlagCurMix.npz"
OFF = dict(pos_bound=1e9, linvel_bound=1e9, angvel_bound=1e9)


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def inputs(card):
    """N random airframes and initial states (attitudes up to pi), the
    committed student's flat weights and a constant action, on the card."""
    g = torch.Generator(device=card).manual_seed(0)
    frames = sample_population(g, N)
    es, _ = L2F(EnvConfig()).reset(frames, g)
    policy = from_numpy(h5.load_actor(NPZ), card)
    action = torch.tensor([0.1, -0.05, 0.02, 0.0], device=card)[:, None].expand(4, N)
    return (frames.to_soa(), es.dynamics.to_soa(), action.contiguous(), policy,
            ops_eval.flatten_policy(policy))


@pytest.mark.cuda
def test_rollout_kernel_matches_plain(inputs):
    ps, ss, act, _, _ = inputs
    before = launches["rollout"]
    out, stats = ops_rollout.rollout_soa(ps, ss, act, 20, **OFF)
    ref_out, ref_stats = ops_rollout.rollout_plain(ps, ss, act, 20, **OFF)
    torch.cuda.synchronize()
    assert launches["rollout"] == before + 1
    torch.testing.assert_close(stats, ref_stats, atol=0, rtol=0)
    torch.testing.assert_close(out, ref_out, atol=2e-4, rtol=1e-3)


@pytest.mark.cuda
def test_eval_kernel_matches_plain(inputs):
    ps, ss, _, policy, weights = inputs
    before = launches["eval"]
    out, stats = ops_eval.eval_soa(weights, ps, ss, 25)
    ref_out, ref_stats = ops_eval.eval_plain(policy, ps, ss, 25)
    torch.cuda.synchronize()
    assert launches["eval"] == before + 1
    agree = (stats[0] == ref_stats[0]) & (stats[1] == ref_stats[1])
    assert int(agree.sum()) >= 0.999 * N
    assert 0 < int(stats[0].sum()) < N  # some envs terminated, some flew on
    torch.testing.assert_close(stats[2][agree], ref_stats[2][agree], atol=5e-3, rtol=1e-3)
    torch.testing.assert_close(out[0:3][:, agree], ref_out[0:3][:, agree], atol=1e-3, rtol=0)


def population(card, n, seed):
    """n random airframes and default initial states on the card."""
    g = torch.Generator(device=card).manual_seed(seed)
    frames = sample_population(g, n)
    return frames.to_soa(), L2F(EnvConfig()).reset(frames, g)[0].dynamics.to_soa()


def student(card, hidden, seed=0):
    """A student of a hidden width from a seed, its biases and h0 drawn from
    N(0, 0.1) (init_params leaves them at 0)."""
    g = torch.Generator(device=card).manual_seed(seed)
    p = network.init_params(g, hidden_dim=hidden)
    for layer, name in (("dense_0", "biases"), ("gru_1", "biases_input"),
                        ("gru_1", "biases_hidden"), ("gru_1", "initial_hidden_state"),
                        ("dense_2", "biases")):
        p[layer][name].add_(0.1 * torch.randn(p[layer][name].shape, device=card, generator=g))
    return p


def assert_eval_agrees(got, want, n):
    (out, stats), (ref_out, ref_stats) = got, want
    agree = (stats[0] == ref_stats[0]) & (stats[1] == ref_stats[1])
    assert int(agree.sum()) >= 0.999 * n
    torch.testing.assert_close(stats[2][agree], ref_stats[2][agree], atol=5e-3, rtol=1e-3)
    torch.testing.assert_close(out[0:3][:, agree], ref_out[0:3][:, agree], atol=1e-3, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [37, 944, 5528, 16384])
def test_rollout_kernel_matches_plain_at_ragged_widths(card, n):
    ps, ss = population(card, n, n)
    act = torch.tensor([0.1, -0.05, 0.02, 0.0], device=card)[:, None].expand(4, n).contiguous()
    out, stats = ops_rollout.rollout_soa(ps, ss, act, 20, **OFF)
    ref_out, ref_stats = ops_rollout.rollout_plain(ps, ss, act, 20, **OFF)
    torch.cuda.synchronize()
    assert ops_rollout.threads_per_env() >= 1
    torch.testing.assert_close(stats, ref_stats, atol=0, rtol=0)
    torch.testing.assert_close(out, ref_out, atol=2e-4, rtol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [37, 944, 5528, 16384])
def test_eval_kernel_matches_plain_at_ragged_widths(inputs, card, n):
    policy, weights = inputs[3], inputs[4]
    ps, ss = population(card, n, n)
    got = ops_eval.eval_soa(weights, ps, ss, 25)
    want = ops_eval.eval_plain(policy, ps, ss, 25)
    torch.cuda.synchronize()
    assert ops_eval.threads_per_env() > 1
    assert_eval_agrees(got, want, n)


@pytest.mark.cuda
@pytest.mark.parametrize("hidden", [8, 16, 24, 32, 48])
def test_eval_kernel_matches_plain_at_hidden_width(inputs, card, hidden):
    ps, ss = inputs[0], inputs[1]
    policy = student(card, hidden)
    weights = ops_eval.flatten_policy(policy)
    before = launches["eval"]
    got = ops_eval.eval_soa(weights, ps, ss, 25)
    want = ops_eval.eval_plain(policy, ps, ss, 25)
    torch.cuda.synchronize()
    assert launches["eval"] == before + 1
    assert 0 < int(got[1][0].sum()) < N  # some envs terminated, some flew on
    assert_eval_agrees(got, want, N)


@pytest.mark.cuda
def test_eval_kernel_matches_plain_with_early_ends_inside_teams(inputs, card):
    """Every third env starts at the position bound flying out and ends at
    step 3 or 4, beside envs from the eval-parity init that fly on: the envs of a
    team (t, t + ceil(N / E), ...) end at different steps, and those that
    ended ride along."""
    from raptor_tpu_torch.env import eval_parity_init

    policy, weights = inputs[3], inputs[4]
    g = torch.Generator(device=card).manual_seed(3)
    frames = sample_population(g, N)
    ps = frames.to_soa()
    ss = L2F(EnvConfig(init=eval_parity_init())).reset(frames, g)[0].dynamics.to_soa()
    early = torch.arange(N, device=card) % 3 == 0
    ss[0, early], ss[7, early] = 0.585, 0.6  # x and its velocity: past 0.6 at step 3 or 4
    got = ops_eval.eval_soa(weights, ps, ss, 100)
    want = ops_eval.eval_plain(policy, ps, ss, 100)
    torch.cuda.synchronize()
    assert_eval_agrees(got, want, N)
    length = got[1][1]
    assert float(length[early].max()) <= 4 and float(length[~early].mean()) > 90
    share = ops_eval.ride_along_share(length, ops_eval.envs_per_team(), ops_eval.lanes_per_team())
    assert (share > 0.1) == (ops_eval.envs_per_team() > 1)


@pytest.mark.cuda
@pytest.mark.parametrize("hidden", [16, 48])
def test_eval_kernel_gates_out_of_range_match_plain(inputs, card, hidden):
    """A student whose GRU r and z gates see pre-activations of -200 on
    every unit: 1 + exp(200) is inf, where the eval kernel's branch-free
    reciprocal (`recip_fast`) leaves its range and the unit's gates take the
    IEEE division (without that, the gate would read NaN)."""
    ps, ss = inputs[0], inputs[1]
    policy = student(card, hidden)
    policy["gru_1"]["biases_input"][: 2 * hidden] = -200.0
    weights = ops_eval.flatten_policy(policy)
    got = ops_eval.eval_soa(weights, ps, ss, 25)
    want = ops_eval.eval_plain(policy, ps, ss, 25)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got[1]).all())
    assert_eval_agrees(got, want, N)


def collect_team() -> int:
    """COLLECT_TEAM, the lanes an env the collect kernel is built with."""
    header = (Path(__file__).resolve().parents[1] / "raptor_tpu_torch" / "csrc"
              / "team_step.cuh").read_text()
    return int(re.search(r"constexpr int COLLECT_TEAM = (\d+);", header).group(1))


def _check_collect_at_width(inputs, card, hidden):
    ps = inputs[0]
    policy = student(card, hidden)
    weights = ops_collect.flatten_policy(policy)
    state = L2F(GENTLE).sample_state(
        DynamicsParams.from_soa(ps), torch.Generator(device=card).manual_seed(2)).to_soa()
    obs, reset = ops_collect.collect_soa(weights, ps, state, 20, 3, 0, GENTLE)
    ref_obs, ref_reset = ops_collect.collect_plain(policy, ps, state, 20, 3, 0, GENTLE)
    torch.cuda.synchronize()
    assert float(ref_reset.sum()) == 0.0
    torch.testing.assert_close(reset, ref_reset, atol=0, rtol=0)
    torch.testing.assert_close(obs, ref_obs, atol=2e-4, rtol=0)
    config = EnvConfig(episode_length=1)  # every row from 1 on is a fresh draw
    obs, reset = ops_collect.collect_soa(weights, ps, state, 10, 5, 0, config)
    ref_obs, ref_reset = ops_collect.collect_plain(policy, ps, state, 10, 5, 0, config)
    torch.testing.assert_close(obs, ref_obs, atol=1e-5, rtol=0)
    assert ops_collect.threads_per_env(hidden) == collect_team()


@pytest.mark.cuda
def test_collect_kernel_matches_plain_at_hidden_width_32(inputs, card):
    _check_collect_at_width(inputs, card, 32)


@pytest.mark.cuda
def test_collect_kernel_matches_plain_at_hidden_width_48(inputs, card):
    _check_collect_at_width(inputs, card, 48)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["rollout", "eval"])
def test_nan_state_ends_its_env_only(inputs, kernel):
    ps, ss, act, _, weights = inputs
    bad = ss.clone()
    bad[1, 3] = float("nan")  # env 3: non-finite position
    if kernel == "rollout":
        run = lambda s: ops_rollout.rollout_soa(ps, s, act, 30)  # noqa: E731
    else:
        run = lambda s: ops_eval.eval_soa(weights, ps, s, 30)  # noqa: E731
    out, stats = run(bad)
    ref_out, ref_stats = run(ss)
    torch.cuda.synchronize()
    assert float(stats[0, 3]) == 0.0 and float(stats[1, 3]) == 1.0
    torch.testing.assert_close(out[:, 3], bad[:, 3], equal_nan=True, atol=0, rtol=0)
    keep = torch.arange(N, device=ss.device) != 3
    torch.testing.assert_close(out[:, keep], ref_out[:, keep], atol=0, rtol=0)
    torch.testing.assert_close(stats[:, keep], ref_stats[:, keep], atol=0, rtol=0)


GENTLE = EnvConfig(
    init=InitConfig(max_angle=0.2, linear_velocity_std=0.02, angular_velocity_std=0.02),
    termination=TerminationConfig(position_bound=50.0, angular_velocity_bound=1000.0),
)


def _collect_both(inputs, config, n_steps, seed, state=None):
    ps, ss, _, policy, weights = inputs
    ss = ss if state is None else state
    got = ops_collect.collect_soa(weights, ps, ss, n_steps, seed, 0, config)
    want = ops_collect.collect_plain(policy, ps, ss, n_steps, seed, 0, config)
    torch.cuda.synchronize()
    return got, want


@pytest.mark.cuda
def test_collect_kernel_matches_plain_without_resets(inputs, card):
    ps = inputs[0]
    frames = DynamicsParams.from_soa(ps)
    state = L2F(GENTLE).sample_state(frames, torch.Generator(device=card).manual_seed(2))
    before = launches["collect"]
    (obs, reset), (ref_obs, ref_reset) = _collect_both(inputs, GENTLE, 20, 3, state.to_soa())
    assert launches["collect"] == before + 1
    assert obs.shape == (20, N, 22) and reset.shape == (20, N)
    assert float(ref_reset.sum()) == 0.0
    torch.testing.assert_close(reset, ref_reset, atol=0, rtol=0)
    torch.testing.assert_close(obs, ref_obs, atol=2e-4, rtol=0)


@pytest.mark.cuda
def test_collect_kernel_truncates_and_resets_like_plain(inputs):
    config = EnvConfig(episode_length=8)
    (obs, reset), (ref_obs, ref_reset) = _collect_both(inputs, config, 20, 11)
    assert float((reset == ref_reset).float().mean()) >= 0.999
    assert float(reset[7].mean()) > 0.9 and float(reset[15].mean()) > 0.9
    after = obs[8][reset[7] == 1.0]  # rows right after a reset are fresh samples
    assert float(after[:, 0:3].abs().max()) <= config.init.position_range + 1e-6
    assert float(after[:, 18:22].abs().max()) == 0.0
    rot = after[:, 3:12].reshape(-1, 3, 3)
    eye = torch.eye(3, device=rot.device).expand_as(rot)
    torch.testing.assert_close(rot @ rot.transpose(1, 2), eye, atol=1e-4, rtol=0)


@pytest.mark.cuda
def test_collect_kernel_prng_matches_plain(inputs):
    """episode_length 1: every row from 1 on is a fresh draw, so the
    observations pin the in-kernel hash, uniforms and sampler."""
    config = EnvConfig(episode_length=1)
    (obs, reset), (ref_obs, ref_reset) = _collect_both(inputs, config, 10, 5)
    assert float(reset.min()) == 1.0 and float(ref_reset.min()) == 1.0
    torch.testing.assert_close(obs, ref_obs, atol=1e-5, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [37, 944, 5528])
def test_collect_kernel_matches_plain_at_ragged_widths(inputs, card, n):
    """n is no multiple of 32: the last warp of the last block is partly
    filled (teams past n are masked) and the channel stride n of the
    [T, 23, n] buffer is unaligned."""
    _, _, _, policy, weights = inputs
    g = torch.Generator(device=card).manual_seed(n)
    frames = sample_population(g, n)
    ps = frames.to_soa()
    state = L2F(GENTLE).sample_state(frames, g).to_soa()
    obs, reset = ops_collect.collect_soa(weights, ps, state, 20, 3, 0, GENTLE)
    ref_obs, ref_reset = ops_collect.collect_plain(policy, ps, state, 20, 3, 0, GENTLE)
    assert obs.shape == (20, n, 22) and reset.shape == (20, n)
    assert float(ref_reset.sum()) == 0.0
    torch.testing.assert_close(reset, ref_reset, atol=0, rtol=0)
    torch.testing.assert_close(obs, ref_obs, atol=2e-4, rtol=0)
    config = EnvConfig(episode_length=1)  # every row from 1 on is a fresh draw
    obs, reset = ops_collect.collect_soa(weights, ps, state, 10, 5, 0, config)
    ref_obs, ref_reset = ops_collect.collect_plain(policy, ps, state, 10, 5, 0, config)
    assert float(reset.min()) == 1.0 and float(ref_reset.min()) == 1.0
    torch.testing.assert_close(obs, ref_obs, atol=1e-5, rtol=0)


@pytest.mark.cuda
def test_collect_nan_state_resets_its_env_only(inputs, card):
    ps = inputs[0]
    weights = inputs[4]
    frames = DynamicsParams.from_soa(ps)
    state = L2F(GENTLE).sample_state(
        frames, torch.Generator(device=card).manual_seed(2)).to_soa()
    bad = state.clone()
    bad[1, 3] = float("nan")  # env 3: non-finite position
    obs, reset = ops_collect.collect_soa(weights, ps, bad, 20, 3, 0, GENTLE)
    ref_obs, ref_reset = ops_collect.collect_soa(weights, ps, state, 20, 3, 0, GENTLE)
    torch.cuda.synchronize()
    assert float(reset[0, 3]) == 1.0 and float(reset[1:, 3].sum()) == 0.0
    assert bool(torch.isnan(obs[0, 3, 1])) and bool(torch.isfinite(obs[1:, 3]).all())
    # row 1 is a fresh start: inside the init box, zero previous action
    assert float(obs[1, 3, 0:3].abs().max()) <= GENTLE.init.position_range + 1e-6
    assert float(obs[1, 3, 18:22].abs().max()) == 0.0
    keep = torch.arange(N, device=card) != 3
    torch.testing.assert_close(obs[:, keep], ref_obs[:, keep], atol=0, rtol=0)
    torch.testing.assert_close(reset[:, keep], ref_reset[:, keep], atol=0, rtol=0)


@pytest.mark.cuda
def test_collect_env_offset_split_equals_the_whole(inputs):
    ps, ss, _, _, weights = inputs
    config, half = EnvConfig(episode_length=1), N // 2
    whole = ops_collect.collect_soa(weights, ps, ss, 6, 5, 0, config)
    parts = [
        ops_collect.collect_soa(weights, ps[:, lo:lo + half].contiguous(),
                                ss[:, lo:lo + half].contiguous(), 6, 5, lo, config)
        for lo in (0, half)
    ]
    torch.cuda.synchronize()
    for i in (0, 1):
        torch.testing.assert_close(torch.cat([p[i] for p in parts], 1), whole[i], atol=0, rtol=0)


@pytest.mark.cuda
def test_wrappers_reject_mixed_devices(inputs):
    ps, ss, act, _, weights = inputs
    with pytest.raises(ValueError):
        ops_rollout.rollout_soa(ps.cpu(), ss, act, 1)
    with pytest.raises(ValueError):
        ops_eval.eval_soa(weights.cpu(), ps, ss, 1)
    with pytest.raises(ValueError):
        ops_collect.collect_soa(weights, ps.cpu(), ss, 1, 0)
    wide = ops_eval.flatten_policy(student(ss.device, 20))  # a width that is not built
    with pytest.raises(ValueError, match="hidden widths"):
        ops_eval.eval_soa(wide, ps, ss, 1)
    with pytest.raises(ValueError, match="hidden widths"):
        ops_collect.collect_soa(wide, ps, ss, 1, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 37, 2048, 2048 + 5, 8 * 256 * 132 + 96, 100_003])
def test_fma_peak_kernel_matches_plain(card, n):
    """Sizes that are and are not multiples of the warp (32), the block (256)
    and the elements a block covers (2,048). rtol 1e-5: kernel and plain
    version both round once a step (see ops/fma_peak.py)."""
    from raptor_tpu_torch.ops import fma_peak as ops_fma_peak

    g = torch.Generator(device=card).manual_seed(n)
    x = 0.5 + torch.rand(n, device=card, generator=g)
    before = launches["fma_peak"]
    got = ops_fma_peak.fma_peak(x, 16, nfma=32)
    want = ops_fma_peak.fma_peak_plain(x, 16, nfma=32)
    torch.cuda.synchronize()
    assert launches["fma_peak"] == before + 1
    assert ops_fma_peak.last_geometry["elements"] == n
    assert ops_fma_peak.last_geometry["grid"] == -(-n // 2048)
    torch.testing.assert_close(got, want, atol=0, rtol=1e-5)
    ones = ops_fma_peak.fma_peak(torch.ones(n, device=card), 64)
    assert bool((ones == ones[0]).all())
    # 9 ulp a step, exactly (8.84 in exact arithmetic: 3.7e-5 off the closed form)
    assert float(ones[0]) == 1.0 + 64 * 32 * 9 * 2.0**-23
    assert abs(float(ones[0]) / ops_fma_peak.closed_form(64 * 32) - 1.0) < 1e-4


@pytest.mark.cuda
def test_fma_peak_kernel_other_nfma_and_refusals(card):
    from raptor_tpu_torch.ops import fma_peak as ops_fma_peak

    x = 0.5 + torch.rand(4099, device=card)
    for nfma in (1, 8, 64):
        torch.testing.assert_close(
            ops_fma_peak.fma_peak(x, 8, nfma=nfma), ops_fma_peak.fma_peak_plain(x, 8, nfma=nfma),
            atol=0, rtol=1e-5)
    with pytest.raises(ValueError):
        ops_fma_peak.fma_peak(x, 8, nfma=3)
    with pytest.raises(ValueError):
        ops_fma_peak.fma_peak(x.double(), 8)


@pytest.mark.cuda
def test_population_super_step_on_the_card(card):
    """One warm-up, one demonstrator collect and one multi-step of 4 teachers
    x 8 envs on the card: finite metrics, counters as on the CPU."""
    from raptor_tpu_torch.distill import population
    from raptor_tpu_torch.rl import sac

    g = torch.Generator(device=card).manual_seed(0)
    env = L2F(EnvConfig())
    pop_cfg = population.PopulationConfig(
        n_teachers=4, envs_per_teacher=8, rollout_length=4, gradient_steps=3, batch_size=16,
        replay_capacity=16, sample_rows=True)
    sac_cfg = sac.SACConfig(stack_critics=True)
    airframes = population.sample_teacher_airframes(g, 4)
    states, env_params, run_cfg = population.population_init(g, env, airframes, pop_cfg, sac_cfg)
    states = population.make_population_warmup(env, run_cfg)(states, env_params)
    states = population.make_population_demo_collect(env, run_cfg, True)(states, env_params)
    states, metrics = population.make_population_multi_step(
        env, run_cfg, sac_cfg, 2)(states, env_params)
    torch.cuda.synchronize()
    assert states.buffer.obs.device.type == "cuda" and states.buffer.obs.shape == (4, 16, 8, 31)
    assert (states.buffer.ptr, states.buffer.size, states.total_env_steps) == (0, 16, 4 * 4 * 8)
    assert states.sac.step == 6
    for name in metrics._fields:
        m = getattr(metrics, name)
        assert m.shape == (4,) and bool(torch.isfinite(m).all()), name
    stats = population.make_population_eval(env, 4, 20)(states.sac, airframes, g)
    assert stats.return_mean.shape == (4,) and bool(torch.isfinite(stats.return_mean).all())
