"""The port's slices end to end, on the CPU: closed-loop evaluation, and
distillation through its two CLIs.

- `rl.evaluation` against the JAX package's `rl.evaluation.evaluate` on
  handed-across airframes and initial states;
- the fused path (`ops.eval`, plain version here) against the eager loop, and
  the CLI's `--fused` and eager modes against each other;
- the distillation CLI and the collect benchmark CLI at a tiny size;
- the `eval_parity` sweep against the JAX package's `evaluate_at_angle` on
  handed-across airframes and states;
- entry points refuse to run without a card unless asked for the CPU;
- the port and `chip_smoke.py` import neither JAX nor `raptor_tpu`;
- `chip_smoke.py` exits non-zero with no result where there is no card.
"""

import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from raptor_tpu.env import EnvConfig as JEnvConfig
from raptor_tpu.env import L2F as JL2F
from raptor_tpu.apps import eval_parity as j_eval_parity
from raptor_tpu.env import presets as jpresets
from raptor_tpu.env.types import InitConfig as JInitConfig
from raptor_tpu.env.types import eval_parity_init as j_eval_parity_init
from raptor_tpu.env import sample_population as jsample
from raptor_tpu.rl import evaluation as jevaluation
from raptor_tpu_torch import bench as bench_module
from raptor_tpu_torch.apps import bench_collect as bench_cli
from raptor_tpu_torch.apps import eval_parity, pre_training, roofline, sample_dynamics
from raptor_tpu_torch.apps import eval_teachers, flight_eval
from raptor_tpu_torch.apps import evaluate as cli
from raptor_tpu_torch.apps import post_training as distill_cli
from raptor_tpu_torch.checkpoint import dynamics_params_from_numpy, from_numpy, h5
from raptor_tpu_torch.checkpoint import state_from_numpy
from raptor_tpu_torch.env import EnvConfig, L2F, eval_parity_init, presets
from raptor_tpu_torch.env import l2f_compat as l2f
from raptor_tpu_torch.env.types import State
from raptor_tpu_torch.inference import Executor
from raptor_tpu_torch.ops import collect as ops_collect
from raptor_tpu_torch.ops import eval as ops_eval
from raptor_tpu_torch.ops import rollout as ops_rollout
from raptor_tpu_torch.policy.entry import entry
from raptor_tpu_torch.policy.raptor import Raptor
from raptor_tpu_torch.rl import evaluation

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H5 = "artifacts/student_rateFlagCurMix.h5"
PACK = "artifacts/teachers_seed900_hovergate.npz"
NPZ = "raptor_tpu_torch/data/student_rateFlagCurMix.npz"
STATS = ["return_mean", "return_std", "episode_length_mean", "episode_length_std",
         "share_terminated"]


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def handed_across():
    """64 JAX-sampled airframes and the initial states JAX's evaluate() draws
    from its key (attitudes up to 1 rad)."""
    n, key = 64, jax.random.key(7)
    jparams = jsample(jax.random.key(3), n)
    jenv = JL2F(JEnvConfig(init=j_eval_parity_init()))
    es, _ = jax.vmap(jenv.reset)(jax.random.split(key, n), jparams)
    return (jenv, jparams, key, n, dynamics_params_from_numpy(to_np(jparams), "cpu"),
            state_from_numpy(to_np(es.dynamics), "cpu"))


def test_evaluate_matches_jax(handed_across):
    jenv, jparams, key, n, tparams, tstate = handed_across
    steps = 100
    p_np = h5.load_actor(H5)
    step_j, carry_j = jevaluation.gru_policy_step(p_np, n)
    ref = jevaluation.evaluate(jenv, jparams, step_j, carry_j, key, n, steps)
    p_t = from_numpy(p_np, "cpu")
    step_t, carry_t = evaluation.gru_policy_step(p_t, n)
    got = evaluation.evaluate_from(
        L2F(EnvConfig(init=eval_parity_init())), tparams, tstate, step_t, carry_t,
        torch.Generator().manual_seed(0), steps,
    )
    for name in STATS:
        np.testing.assert_allclose(
            float(getattr(got, name)), float(getattr(ref, name)), rtol=1e-4, atol=1e-4,
            err_msg=name,
        )
    assert float(got.episode_length_mean) > 90


def test_fused_path_matches_eager_loop(handed_across):
    """Fused and eager loops differ only in what a dead env's state freezes
    to, which no statistic reads."""
    *_, n, tparams, tstate = handed_across
    p_t = from_numpy(h5.load_actor(NPZ), "cpu")
    _, alive, length, ret = ops_eval.fused_policy_eval(p_t, tparams, tstate, 80, device="cpu")
    step_t, carry_t = evaluation.gru_policy_step(p_t, n)
    eager = evaluation.evaluate_from(
        L2F(EnvConfig()), tparams, tstate, step_t, carry_t, torch.Generator(), 80
    )
    np.testing.assert_allclose(float(ret.mean()), float(eager.return_mean), rtol=1e-5)
    assert float(length.mean()) == float(eager.episode_length_mean)
    assert float(1 - alive.mean()) == float(eager.share_terminated)


def test_cli_fused_and_eager_agree(capsys):
    args = [NPZ, "--device", "cpu", "--n-airframes", "4", "--envs-per-airframe", "4",
            "--episode-length", "60", "--eval-parity-init", "--seed", "5"]
    fused = cli.main(args + ["--fused"])
    eager = cli.main(args)
    printed = json.loads(capsys.readouterr().out.split("\n}\n")[0] + "}")
    assert printed == fused
    assert fused.pop("kernel") == "fused"
    assert fused.keys() == eager.keys()
    assert fused["episodes"] == 16
    for k in ("return/mean", "return/std", "episode_length/mean", "episode_length/std",
              "share_terminated"):
        np.testing.assert_allclose(fused[k], eager[k], rtol=1e-5, atol=1e-6, err_msg=k)


def test_cli_reads_h5_and_presets():
    out = cli.main([H5, "--device", "cpu", "--airframe", "crazyflie",
                    "--envs-per-airframe", "3", "--episode-length", "20"])
    assert out["episodes"] == 3 and out["airframe"] == "crazyflie"
    assert np.isfinite(out["return/mean"])


def test_post_training_cli_runs_on_cpu(tmp_path, capsys):
    """Two aggregated rounds with the demonstrator flags on 3 of the pack's
    teachers: a verified checkpoint, the loss history, the round-hook
    evaluation and the per-phase seconds come back."""
    path, summary = distill_cli.main([
        PACK, "--device", "cpu", "--rounds", "2", "--envs-per-teacher", "2",
        "--teachers-per-round", "3", "--aggregate-capacity", "16", "--grad-steps-per-round", "2",
        "--batch-size", "4", "--eval-every-rounds", "2", "--teacher-mix-rounds", "3",
        "--collect-angle-power", "4", "--demo-tilt", "1.2", "--demo-rate", "5.0",
        "--demo-adaptive", "--demo-w-cap", "999", "--demo-k-w", "999", "--demo-c-flip", "0.5",
        "--demo-c-lag", "1.2", "--demo-c-bw", "3.0", "--eval-max-angle", "1.0",
        "--experiments-dir", str(tmp_path),
    ], return_summary=True)
    assert "self-test max-err" in capsys.readouterr().out
    assert os.path.isfile(path) and path.startswith(str(tmp_path))
    assert h5.verify_checkpoint(path) < 1e-5
    student = from_numpy(h5.load_actor(path), "cpu")
    assert student["gru_1"]["weights_input"].shape == (48, 16)
    assert len(summary["loss_history"]) == 2 and np.all(np.isfinite(summary["loss_history"]))
    (evaluated,) = summary["evaluations"]
    assert evaluated["round"] == 1 and evaluated["env_steps"] == 2 * 500 * 3 * 2
    five = ["evaluation/return/mean", "evaluation/return/std", "evaluation/episode_length/mean",
            "evaluation/episode_length/std", "evaluation/share_terminated"]
    assert all(np.isfinite(evaluated[k]) for k in five)
    assert all(np.isfinite(evaluated[k]) for k in
               ("crazyflie/return/mean", "fullinit/return/mean", "fullinit/share_terminated"))
    assert {k: len(v) for k, v in summary["seconds"].items()} == {
        "collect": 2, "aggregate_add": 2, "train": 2}
    run_dir = os.path.dirname(os.path.dirname(path))
    with open(os.path.join(run_dir, "summary.json")) as f:
        assert json.load(f)["checkpoint"] == path
    names = os.listdir(os.path.dirname(path))
    assert len(names) == 2  # the round-hook checkpoint and the final one
    assert any(n.startswith("events.out.tfevents") for n in os.listdir(run_dir))


def test_bench_collect_cli_runs_on_cpu(tmp_path):
    out = str(tmp_path / "report.json")
    before = ops_collect.launches
    report = bench_cli.main(["--synthetic", "4", "--rollout-length", "20", "--reps", "1",
                             "--device", "cpu", "--out", out])
    assert ops_collect.launches == before  # the CPU path runs the plain version
    assert report["parity_ok"] and report["parity_step1_err"] < 1e-4
    assert report["parity_resets_first2"] == 0.0 and report["labels_finite_in_unit_box"]
    assert report["teachers"] == 4 and report["env_steps_per_round"] == 4 * 8 * 20
    assert report["device"] == "cpu"
    for key in ("eager_collect_s", "eager_collect_steps_per_s", "fused_collect_s",
                "fused_collect_steps_per_s", "speedup", "trajectory_drift_100steps"):
        assert np.isfinite(report[key]) and report[key] >= 0.0
    with open(out) as f:
        assert json.load(f) == report
    with pytest.raises(SystemExit):
        bench_cli.main(["--device", "cpu"])  # neither a manifest nor --synthetic


@pytest.mark.parametrize("airframe,angle", [("random", 0.4), ("random", 1.0), ("crazyflie", 1.0)])
def test_eval_parity_matches_jax_evaluate_at_angle(airframe, angle):
    """The committed student at two angles, 2 airframes x 2 envs, the full
    500 steps, from the airframes and initial states the JAX function draws
    from its key."""
    n_air, per = 2, 2
    m, key = n_air * per, jax.random.key(11)
    p_np = h5.load_actor(H5)
    ref = j_eval_parity.evaluate_at_angle(p_np, angle, key, n_air, per, airframe)
    if airframe == "random":
        frames = jsample(jax.random.fold_in(key, 7), n_air)
        stacked = jax.tree.map(lambda x: jax.numpy.repeat(x, per, axis=0), frames)
    else:
        one = jpresets.crazyflie()
        stacked = jax.tree.map(lambda x: jax.numpy.broadcast_to(x, (m,) + x.shape), one)
    jenv = JL2F(JEnvConfig(init=JInitConfig(max_angle=angle)))
    es, _ = jax.vmap(jenv.reset)(jax.random.split(key, m), stacked)
    policy = from_numpy(p_np, "cpu")
    for fused in (False, True):
        got = eval_parity.evaluate_at_angle(
            policy, angle, torch.Generator().manual_seed(0), n_air, per, airframe, fused=fused,
            stacked=dynamics_params_from_numpy(to_np(stacked), "cpu"),
            state=state_from_numpy(to_np(es.dynamics), "cpu"))
        for name in STATS:
            np.testing.assert_allclose(
                float(getattr(got, name)), float(getattr(ref, name)), rtol=1e-3, atol=1e-3,
                err_msg=f"{name} fused={fused}")
    assert float(got.episode_length_mean) > 100.0


def test_eval_parity_cli_scores_a_student_without_the_reference(tmp_path, monkeypatch, capsys):
    monkeypatch.delenv("RAPTOR_REFERENCE_DIR", raising=False)
    out = str(tmp_path / "sweep.json")
    have_shipped = True
    try:
        eval_parity.shipped_checkpoint_path()
    except FileNotFoundError:
        have_shipped = False
    report = eval_parity.main(["--checkpoint", NPZ, "--angles", "0.3,3.0", "--n-airframes", "2",
                               "--envs-per-airframe", "2", "--fused", "--device", "cpu",
                               "--out", out])
    assert [row["max_angle"] for row in report["sweep"]] == [0.3, 3.0]
    for row in report["sweep"]:
        assert ("aggregate" in row) == have_shipped  # shipped rows only with the reference
        for who in ("student_crazyflie", "student_aggregate"):
            assert set(row[who]) == {"episode_length", "share_terminated", "return"}
            assert all(np.isfinite(v) for v in row[who].values())
    gentle, severe = report["sweep"]
    assert gentle["student_aggregate"]["episode_length"] == 500.0
    assert severe["student_aggregate"]["return"] < gentle["student_aggregate"]["return"]
    assert report["fused"] and report["device"] == "cpu"
    with open(out) as f:
        assert json.load(f) == report
    assert "cf len" in capsys.readouterr().out
    if not have_shipped:
        assert report["eval_parity_max_angle"] is None
        with pytest.raises(SystemExit):
            eval_parity.main(["--device", "cpu"])  # nothing to score


ENTRY_POINTS = {
    "pre_training_cli": lambda: pre_training.main(["--population", "2", "--super-steps", "1"]),
    "sample_dynamics_cli": lambda: sample_dynamics.main(["--n", "1", "--out", "unused_dir"]),
    "eval_parity_cli": lambda: eval_parity.main(["--checkpoint", NPZ]),
    "roofline_cli": lambda: roofline.main([]),
    "measure_fma_peak": lambda: roofline.measure_fma_peak(),
    "bench": lambda: bench_module.main([]),
    "entry": lambda: entry(),
    "post_training_cli": lambda: distill_cli.main([PACK, "--rounds", "1"]),
    "bench_collect_cli": lambda: bench_cli.main(["--synthetic", "2", "--rollout-length", "4"]),
    "load_teachers": lambda: distill_cli.load_teachers(PACK),
    "make_fused_collect": lambda: ops_collect.make_fused_collect(
        from_numpy(h5.load_actor(NPZ), "cpu"), 5),
    "fused_collect": lambda: ops_collect.fused_collect(
        from_numpy(h5.load_actor(NPZ), "cpu"), presets.crazyflie("cpu"), _hover_state(), 5, 0),
    "Raptor": lambda: Raptor(NPZ),
    "cli": lambda: cli.main([NPZ, "--fused", "--n-airframes", "1", "--envs-per-airframe", "1"]),
    "fused_policy_eval": lambda: ops_eval.fused_policy_eval(
        from_numpy(h5.load_actor(NPZ), "cpu"), presets.crazyflie("cpu"), _hover_state(), 5),
    "make_fused_policy_eval": lambda: ops_eval.make_fused_policy_eval(
        from_numpy(h5.load_actor(NPZ), "cpu"), 5),
    "fused_rollout": lambda: ops_rollout.fused_rollout(
        presets.crazyflie("cpu"), _hover_state(), torch.zeros(1, 4), 5),
    "Executor": lambda: Executor(h5.load_actor(NPZ)),
    "l2f_Device_vector8": lambda: l2f.sample_initial_parameters(
        l2f.Device(), l2f.vector8.VectorEnvironment(), l2f.vector8.VectorParameters(),
        l2f.vector8.VectorRng()),
    "eval_teachers_cli": lambda: eval_teachers.main([PACK, "--episodes", "1"]),
    "flight_eval_record": lambda: flight_eval.main(
        ["record", "unused.csv", "--checkpoint", NPZ, "--steps", "1"]),
}


def _hover_state():
    z = torch.zeros(1, 3)
    return State(z, torch.tensor([[1.0, 0, 0, 0]]), z, z, torch.full((1, 4), 0.7))


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_entry_points_default_to_the_card(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[name]()


def test_entry_points_run_on_cpu_when_asked():
    _, alive, length = ops_rollout.fused_rollout(
        presets.crazyflie("cpu"), _hover_state(), torch.zeros(1, 4), 5, device="cpu")
    assert float(length[0]) == 5.0 and float(alive[0]) == 1.0
    a = Raptor(NPZ, device="cpu").evaluate_step(np.zeros(22, np.float32))
    assert a.shape == (4,) and np.all(np.isfinite(a))


IMPORT_CHECK = """
import importlib, pkgutil, sys
sys.path.insert(0, {root!r})
import raptor_tpu_torch
for m in pkgutil.walk_packages(raptor_tpu_torch.__path__, "raptor_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "raptor_tpu"))
assert not bad, bad
print("clean", len([m for m in sys.modules if m.startswith("raptor_tpu_torch")]))
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    proc = subprocess.run(
        [sys.executable, "-c", IMPORT_CHECK.format(root=ROOT)],
        capture_output=True, text=True, cwd=ROOT, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("clean")
    assert int(proc.stdout.split()[1]) >= 58  # every module of the package was imported


def test_no_file_of_the_port_names_jax_in_an_import():
    """Over every source file of the package and `chip_smoke.py`, new ones
    included: no import statement of jax, flax, optax or the JAX package."""
    import re

    pattern = re.compile(r"^\s*(?:from|import)\s+(jax|jaxlib|flax|optax|raptor_tpu)(?:[.\s]|$)",
                         re.M)
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(os.path.join(ROOT, "raptor_tpu_torch")):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    assert len(files) >= 58
    for path in files:
        with open(path) as f:
            assert not pattern.search(f.read()), path
    for new in ("bench.py", "rl/sac.py", "rl/replay.py", "rl/runner.py", "ops/fma_peak.py",
                "apps/roofline.py", "apps/pre_training.py", "apps/sample_dynamics.py",
                "apps/eval_parity.py", "policy/entry.py", "checkpoint/code_export.py",
                "checkpoint/rltools_export.py", "inference/__init__.py", "inference/native.py",
                "inference/executor.py", "apps/export_policy.py", "env/ui.py",
                "env/l2f_compat.py", "apps/eval_teachers.py", "apps/filter_teachers.py",
                "utils/flightlog.py", "apps/flight_eval.py"):
        assert os.path.join(ROOT, "raptor_tpu_torch", new) in files


def test_chip_smoke_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), alone)
    for script, cwd in ((os.path.join(ROOT, "chip_smoke.py"), ROOT), (str(alone), tmp_path)):
        proc = subprocess.run([sys.executable, script], capture_output=True, text=True,
                              cwd=cwd, timeout=120)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout and '"kernels"' not in proc.stdout
