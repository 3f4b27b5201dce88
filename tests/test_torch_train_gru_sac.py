"""The recurrent training CLI (`raptor_tpu_torch/apps/train_gru_sac.py`) on the
CPU at a tiny size: with and without `--init-actor` on the committed student,
its checkpoint (the actor's mu head, read back exactly), the `.npz` route where
h5py is missing, and its refusal to run on a card that is not there. The
fine-tuned actor must stay within 0.05 of the grafted student after 16
updates at a learning rate of 3e-4 (Adam moves a weight by at most about the
learning rate an update).
"""

import glob
import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

from raptor_tpu_torch.apps import train_gru_sac as cli
from raptor_tpu_torch.checkpoint import h5
from raptor_tpu_torch.utils.tfevents import read_scalars

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STUDENT = os.path.join(ROOT, "raptor_tpu_torch", "data", "student_rateFlagCurPure.npz")
TINY = ["--n-envs", "8", "--super-steps", "2", "--rollout-length", "8", "--seq-len", "8",
        "--burn-in", "2", "--device", "cpu", "--eval-every", "2"]


def run_cli(tmp_path, monkeypatch, extra=()):
    """Run the CLI; returns (checkpoint path, the final actor it exported,
    the run's logged scalars)."""
    seen = {}
    real = cli.mu_actor

    def spy(actor):
        seen["actor"] = {k: {n: v.detach().clone() for n, v in t.items()} for k, t in actor.items()}
        return real(actor)

    monkeypatch.setattr(cli, "mu_actor", spy)
    path = cli.main([*TINY, "--experiments-dir", str(tmp_path), *extra])
    events = glob.glob(os.path.join(os.path.dirname(os.path.dirname(path)), "events.out.*"))
    return path, seen["actor"], read_scalars(events[0])


@pytest.mark.parametrize("init_actor", [False, True])
def test_cli_trains_evaluates_and_writes_the_mu_head(tmp_path, monkeypatch, init_actor):
    extra = ["--init-actor", STUDENT] if init_actor else []
    path, actor, scalars = run_cli(tmp_path, monkeypatch, extra)
    assert os.path.isfile(path) and path.endswith(
        ".h5" if importlib.util.find_spec("h5py") else ".npz")
    saved = h5.load_actor(path)
    # the mu head: the first 4 rows of the 8-row head, the backbone as is
    assert actor["dense_2"]["weights"].shape == (8, 16)
    np.testing.assert_array_equal(saved["dense_2"]["weights"],
                                  actor["dense_2"]["weights"][:4].numpy())
    np.testing.assert_array_equal(saved["dense_2"]["biases"], actor["dense_2"]["biases"][:4].numpy())
    for layer in ("dense_0", "gru_1"):
        for k, v in actor[layer].items():
            np.testing.assert_array_equal(saved[layer][k], v.numpy())
    ex_in, ex_out = h5.load_example_io(path)
    assert ex_in.shape[-1] == 22 and np.all(np.isfinite(ex_out))
    for tag in cli.EVAL_TAGS.values():
        (step, value), = scalars[tag]
        assert step == 2 * 8 * 8 and np.isfinite(value)
    student = h5.load_actor(STUDENT)
    gap = max(float(np.abs(saved[layer][k] - student[layer][k]).max())
              for layer in student for k in student[layer])
    if init_actor:
        # grafted, then fine-tuned for 16 updates
        assert gap < 0.05
        np.testing.assert_allclose(actor["dense_2"]["biases"][4:].numpy(), -2.0, atol=0.05)
    else:
        assert gap > 0.1


def test_cli_writes_npz_without_h5py(tmp_path, monkeypatch):
    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == "h5py" else real(name, *a))
    monkeypatch.setitem(sys.modules, "h5py", None)  # any import of h5py now fails
    path, actor, _ = run_cli(tmp_path, monkeypatch, ["--init-actor", STUDENT])
    assert path.endswith(".npz")
    saved = h5.load_actor(path)
    np.testing.assert_array_equal(saved["gru_1"]["weights_hidden"],
                                  actor["gru_1"]["weights_hidden"].numpy())


def test_cli_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--n-envs", "8", "--super-steps", "1", "--experiments-dir", str(tmp_path)])
    args = cli.parse_args([])
    assert (args.device, args.n_envs, args.rollout_length, args.gradient_steps,
            args.batch_size, args.seq_len, args.burn_in, args.warmup_super_steps,
            args.privileged_critics) == ("cuda", 256, 64, 8, 64, 64, 8, 8, True)
