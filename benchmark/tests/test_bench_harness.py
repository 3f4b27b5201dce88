"""The harness is driven by data: a configuration, a traffic mix, a cell, its
limits and a per-layer metric added as new files and entries only are found
and run, here at a tiny size on the CPU. And the pieces of the result line."""

import json
import os
import shutil
import subprocess
import sys

import pytest

import tinycell

import core

BENCH, ROOT = tinycell.BENCH, tinycell.ROOT

NEW_METRIC = '''"""Students the requests take in turn."""


def read(ctx):
    return len(ctx.cell.traffic["students"])
'''


@pytest.fixture(scope="module")
def grown_tree(tmp_path_factory):
    """A checkout with the benchmark as committed plus new files only: a
    configuration, a traffic mix, limits and a per-layer metric, and their
    entries in BENCHMARK.json."""
    root = tmp_path_factory.mktemp("checkout")
    shutil.copytree(BENCH, root / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(os.path.join(ROOT, "raptor_tpu_torch"), root / "raptor_tpu_torch")
    spec = core.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    config = core.load_json(os.path.join(BENCH, "configs", "raptor_gru16.json"))
    config["eval"].update(n_airframes=4)
    (root / "benchmark/configs/gru16_small.json").write_text(json.dumps(config))
    traffic = core.load_json(os.path.join(BENCH, "traffic", "eval_checkpoints.json"))
    traffic.update(students=["rateFlagCurPure"])
    (root / "benchmark/traffic/pure_only.json").write_text(json.dumps(traffic))
    (root / "benchmark/metrics/students_in_turn.py").write_text(NEW_METRIC)
    limits = {"limits": {k: {"limit": 1e-3} for k in
                         ("mismatch_share", "return_err_p50", "state_err_p50", "summary_gap")}}
    (root / "benchmark/limits/pure_small.json").write_text(json.dumps(limits))
    spec["configs"].append({"name": "gru16_small", "source": "https://github.com/rl-tools/raptor",
                            "file": "benchmark/configs/gru16_small.json", "reduced": [],
                            "why": "test"})
    spec["workloads"].append({"name": "pure_small", "config": "gru16_small",
                              "traffic": "pure_only", "chips": 1, "why": "test"})
    for m in spec["end_to_end"]:
        if "eval_checkpoints" in m.get("workloads", []):
            m["workloads"].append("pure_small")
    spec["per_layer"].append({"name": "students_in_turn", "unit": "students", "better": "higher",
                              "source": "program_counter", "layer": "harness",
                              "moves": "eval_episodes_per_s", "workloads": ["pure_small"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


def run_in(root, trace):
    code = (f"import sys, json; sys.path[:0] = [{str(root / 'benchmark' / 'tests')!r}]\n"
            "import tinycell\n"
            f"print(json.dumps(tinycell.run('pure_small', trace={trace}, seconds=0.3)))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=root, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_new_files_only_give_a_new_cell_config_and_metric(grown_tree):
    plain = run_in(grown_tree, False)
    assert plain["correct"] is True and plain["failed"] == 0 and plain["attempted"] > 0
    assert set(plain["metrics"]) == {"setup_s", "eval_episodes_per_s", "eval_latency_ms_p95"}
    assert list(plain)[-1] == "checks"
    traced = run_in(grown_tree, True)
    assert traced["metrics"] == {"students_in_turn": {"value": 1.0, "unit": "students"}}
    assert traced["correct"] is True


def test_committed_cells_report_their_metrics():
    spec = core.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    for w in spec["workloads"]:
        cell = core.find_cell(w["name"])
        assert "setup_s" in {m["name"] for m in cell.end_to_end}
        assert len(cell.end_to_end) >= 2 and cell.per_layer, w["name"]
        for m in cell.per_layer:
            assert os.path.exists(os.path.join(BENCH, "metrics", f"{m['name']}.py"))
        assert set(cell.traffic["metrics"].values()) == \
            {m["name"] for m in cell.end_to_end} - {"setup_s"}
        assert cell.limits is not None, w["name"]


def test_judge_needs_every_number_under_its_limit():
    limits = {"limits": {"a": {"limit": 1.0}, "b": {"limit": 2.0}}}
    assert core.judge({"a": 0.5, "b": 2.0}, limits)[0] is True
    assert core.judge({"a": 1.5, "b": 1.0}, limits)[0] is False
    assert core.judge({"a": 0.5}, limits)[0] is False
    assert core.judge({"a": 0.5, "b": 1.0, "c": 0.0}, limits)[0] is False
    assert core.judge({"a": float("nan"), "b": 1.0}, limits)[0] is False
    assert core.judge({"a": 0.5}, None)[0] is False
    ok, checks = core.judge({"a": float("inf"), "b": 1.0}, limits)
    assert ok is False and json.dumps(checks, allow_nan=False)


def test_derived_seeds():
    big = 2**31 + 12345
    assert core.derive_seed(big, "a", 1) == core.derive_seed(big, "a", 1)
    assert core.derive_seed(big, "a", 1) != core.derive_seed(big, "a", 2)
    assert 0 <= core.derive_seed(2**40, "x") < 2**63


def _run_py(cwd, workload="eval_checkpoints"):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", workload, "--seed", str(2**31 + 3),
         "--seconds", "1", "--trace", "0"], capture_output=True, text=True, cwd=cwd, timeout=300,
        env={k: v for k, v in os.environ.items() if k != "CUDA_VISIBLE_DEVICES"})


def test_refuses_without_the_program(tmp_path):
    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    out = _run_py(tmp_path)
    assert out.returncode != 0 and out.stdout == ""


def test_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = _run_py(ROOT)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA" in out.stderr
