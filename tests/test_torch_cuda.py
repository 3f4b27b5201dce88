"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test carries the `cuda` marker and skips where torch sees no CUDA
device. The file imports neither JAX nor the JAX package, so it also runs
where only PyTorch is installed (the JAX-importing tests/conftest.py is then
left out):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances are chip_smoke.py's: rollout atol 2e-4 / rtol 1e-3 over 20 steps
with termination off; eval alive and length equal on >= 99.9 % of envs, and
on those return within 5e-3 / 1e-3 and position within 1e-3, over 25 steps.
"""

import pytest
import torch

from raptor_tpu_torch.checkpoint import from_numpy, h5
from raptor_tpu_torch.env import EnvConfig, L2F
from raptor_tpu_torch.env.randomization import sample_population
from raptor_tpu_torch.ops import eval as ops_eval
from raptor_tpu_torch.ops import rollout as ops_rollout

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
    before = ops_rollout.launches
    out, stats = ops_rollout.rollout_soa(ps, ss, act, 20, **OFF)
    ref_out, ref_stats = ops_rollout.rollout_plain(ps, ss, act, 20, **OFF)
    torch.cuda.synchronize()
    assert ops_rollout.launches == before + 1
    torch.testing.assert_close(stats, ref_stats, atol=0, rtol=0)
    torch.testing.assert_close(out, ref_out, atol=2e-4, rtol=1e-3)


@pytest.mark.cuda
def test_eval_kernel_matches_plain(inputs):
    ps, ss, _, policy, weights = inputs
    before = ops_eval.launches
    out, stats = ops_eval.eval_soa(weights, ps, ss, 25)
    ref_out, ref_stats = ops_eval.eval_plain(policy, ps, ss, 25)
    torch.cuda.synchronize()
    assert ops_eval.launches == before + 1
    agree = (stats[0] == ref_stats[0]) & (stats[1] == ref_stats[1])
    assert int(agree.sum()) >= 0.999 * N
    assert 0 < int(stats[0].sum()) < N  # some envs terminated, some flew on
    torch.testing.assert_close(stats[2][agree], ref_stats[2][agree], atol=5e-3, rtol=1e-3)
    torch.testing.assert_close(out[0:3][:, agree], ref_out[0:3][:, agree], atol=1e-3, rtol=0)


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


@pytest.mark.cuda
def test_wrappers_reject_mixed_devices(inputs):
    ps, ss, act, _, weights = inputs
    with pytest.raises(ValueError):
        ops_rollout.rollout_soa(ps.cpu(), ss, act, 1)
    with pytest.raises(ValueError):
        ops_eval.eval_soa(weights.cpu(), ps, ss, 1)
