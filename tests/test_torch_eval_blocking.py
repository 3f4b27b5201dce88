"""The eval kernel's teams fly several envs each (`csrc/team_step.cuh`
`EvalTeam<H>`: K lanes fly E envs, and every weight a lane loads serves all
E). Each env's sums keep the order of a team of one env, so its bits must not
depend on E.

Held here on the CPU through the host build of the kernel's code
(`csrc/host_shim.cpp`, a team's lanes phase by phase): `raptor_eval_host`
(the width's E) against `raptor_eval_unblocked_host` (the same lanes, one
env a team), state and stats bit for bit, at every built width, at env
counts that leave a ragged edge (37, 1,001), with envs of a team dying at
different steps, and with one env of a team ending at step 3 while its
partner flies all 500. Also `ops.eval.ride_along_share`, the waste that
flying several envs a team adds (on the card a warp's teams fly every step
together), on lengths whose answer is known.
"""

import shutil

import pytest
import torch

from raptor_tpu_torch.checkpoint import from_numpy, h5
from raptor_tpu_torch.env import EnvConfig, L2F, eval_parity_init
from raptor_tpu_torch.env.randomization import sample_population
from raptor_tpu_torch.ops import build
from raptor_tpu_torch.ops import eval as ops_eval
from raptor_tpu_torch.policy import network

NPZ = "raptor_tpu_torch/data/student_rateFlagCurMix.npz"


@pytest.fixture(scope="module")
def host():
    if shutil.which("g++") is None:
        pytest.skip("g++ not found: the host build of the kernels' code needs it")
    return build.host_library()


def run(fn, weights, ps, ss, n_steps):
    out, stats = torch.empty_like(ss), torch.empty((3, ss.shape[1]))
    rc = fn(weights.data_ptr(), ps.data_ptr(), ss.data_ptr(), out.data_ptr(), stats.data_ptr(),
            ss.shape[1], n_steps, ops_eval.hidden_width(weights), 0.01, 0.6, 1000.0, 35.0,
            *ops_eval._reward_args(ops_eval.RewardConfig()))
    assert rc == 0
    return out, stats


def both(host, weights, ps, ss, n_steps):
    """(blocked, unblocked) runs of the host build, each (state, stats)."""
    return (run(host.raptor_eval_host, weights, ps, ss, n_steps),
            run(host.raptor_eval_unblocked_host, weights, ps, ss, n_steps))


def assert_bit_equal(got, want):
    for g, w in zip(got, want):
        assert torch.equal(g, w), (g != w).nonzero()[:5].tolist()


def population(n, seed, init=None):
    g = torch.Generator().manual_seed(seed)
    frames = sample_population(g, n)
    es, _ = L2F(EnvConfig() if init is None else EnvConfig(init=init)).reset(frames, g)
    return frames.to_soa(), es.dynamics.to_soa()


def student(hidden):
    """A student of a hidden width from a seed, its biases and h0 drawn from
    N(0, 0.1) (init_params leaves them at 0), so every sum's first term
    counts."""
    g = torch.Generator().manual_seed(hidden)
    p = network.init_params(g, hidden_dim=hidden)
    for layer, name in (("dense_0", "biases"), ("gru_1", "biases_input"),
                        ("gru_1", "biases_hidden"), ("gru_1", "initial_hidden_state"),
                        ("dense_2", "biases")):
        p[layer][name].add_(0.1 * torch.randn(p[layer][name].shape, generator=g))
    return ops_eval.flatten_policy(p)


@pytest.mark.parametrize("n", [37, 1001])
@pytest.mark.parametrize("hidden", ops_eval.HIDDEN_WIDTHS)
def test_blocked_eval_equals_one_env_a_team(host, hidden, n):
    """Attitudes up to pi: envs of one team die at different steps, and the
    last team of a ragged N has empty slots."""
    ps, ss = population(n, 1000 + n)
    got, want = both(host, student(hidden), ps, ss, 60)
    assert_bit_equal(got, want)
    alive = got[1][0]
    assert 0 < int(alive.sum()) < n  # some envs ended, some flew all 60 steps
    assert host.raptor_eval_envs_host(hidden) >= 1


def test_env_ending_at_step_3_beside_one_flying_500(host):
    """The committed student from the eval-parity init, with env 0 started
    at the position bound, flying out: it ends at step 3 while the env that
    shares its team (env ceil(n / E)) flies all 500 steps."""
    n = 8
    ps, ss = population(n, 7, eval_parity_init())
    ss[0, 0], ss[7, 0] = 0.585, 0.6  # x and its velocity: past 0.6 at step 3
    envs = host.raptor_eval_envs_host(16)
    partner = -(-n // envs) if envs > 1 else 1
    weights = ops_eval.flatten_policy(from_numpy(h5.load_actor(NPZ), "cpu"))
    got, want = both(host, weights, ps, ss, 500)
    assert_bit_equal(got, want)
    stats = got[1]
    assert stats[:, 0].tolist()[:2] == [0.0, 3.0]
    assert stats[:, partner].tolist()[:2] == [1.0, 500.0]
    assert float(got[0][0, 0]) <= 0.6  # the pre-step state of its last step


@pytest.mark.parametrize("lengths,envs,lanes,share", [
    ([3.0, 500.0, 500.0, 500.0], 2, 16, 497.0 / 1503.0),  # one warp: teams 0 and 1
    ([4.0, 6.0, 5.0], 2, 32, (1.0 + 6.0) / 15.0),  # a warp a team; team 1's 2nd slot empty
    ([4.0, 6.0, 5.0], 2, 16, (4 * 6.0 - 15.0) / 15.0),  # one warp of 4 slots
    ([1.0, 2.0, 3.0, 4.0, 5.0, 6.0], 2, 16, (5 * 4 - 12.0 + 6 * 4 - 9.0) / 21.0),  # 2 warps
    ([2.0, 2.0, 2.0, 2.0, 9.0], 4, 32, (3 * 7.0 + 3 * 2.0) / 17.0),  # 2 teams, 3 empty slots
    ([4.0, 6.0, 5.0], 1, 2, 0.0),  # one env a team: a team leaves alone
])
def test_ride_along_share(lengths, envs, lanes, share):
    got = ops_eval.ride_along_share(torch.tensor(lengths), envs, lanes)
    assert got == pytest.approx(share, rel=1e-6)
