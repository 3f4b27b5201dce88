"""The port's accounting path on the CPU: the FMA peak probe (kernel B4's
plain version and the g++ build of its per-element function) against the JAX
package's Pallas kernel in interpret mode, the roofline report and its hand
flop counts, and the bench at its `--small` shapes with the roofline report
reading its line.

Tolerances: the probe rtol 1e-5 at 64 x 32 steps (on inputs of 1.0 every
version adds exactly 9 float32 ulp a step, see `ops/fma_peak.py`; rounding
`y * a + b` twice or once makes no difference there); the flop counts within a
factor of 2 of XLA's cost analysis for the deterministic step, which is the
count every utilization divides by, and within a factor of 3 for the keyed
counts, where Philox costs less than threefry.
"""

import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from raptor_tpu.apps import roofline as jroofline
from raptor_tpu_torch import bench as bench_module
from raptor_tpu_torch.apps import roofline
from raptor_tpu_torch.ops import fma_peak as ops_fma_peak
from raptor_tpu_torch.utils.profiling import launches

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_KEYS = [
    "dynamics_step_flops_deterministic", "dynamics_step_transcendentals_deterministic",
    "dynamics_step_flops", "dynamics_step_transcendentals", "env_step_flops",
    "env_step_transcendentals",
]


def pallas_probe(x, depth, nfma):
    """The body of `measure_vpu_peak`'s inner kernel (raptor_tpu/apps/
    roofline.py:105-114) at a depth the CPU can run, in interpret mode."""

    def kernel(x_ref, o_ref, *, depth):
        y = x_ref[...]
        a, b = 1.000001, 1e-7

        def body(_, y):
            for _ in range(nfma):
                y = y * a + b
            return y

        o_ref[...] = jax.lax.fori_loop(0, depth, body, y)

    rows = x.shape[0]
    return pl.pallas_call(
        functools.partial(kernel, depth=depth),
        out_shape=jax.ShapeDtypeStruct((rows, 128), jnp.float32),
        in_specs=[pl.BlockSpec((rows, 128), lambda: (0, 0))],
        out_specs=pl.BlockSpec((rows, 128), lambda: (0, 0)),
        interpret=True,
    )(x)


@pytest.mark.parametrize("version", ["plain", "host"])
@pytest.mark.parametrize("depth,nfma", [(64, 32), (16, 8)])
def test_fma_probe_matches_pallas_interpret(version, depth, nfma):
    x = np.ones((8, 128), np.float32)
    ref = np.asarray(pallas_probe(jnp.asarray(x), depth, nfma))
    fn = ops_fma_peak.fma_peak_plain if version == "plain" else ops_fma_peak.fma_peak_host
    got = fn(torch.from_numpy(x), depth, nfma).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=0)
    assert np.all(got == got[0, 0])
    assert got[0, 0] == np.float32(1.0 + depth * nfma * 9 * 2.0**-23)
    np.testing.assert_allclose(got[0, 0], ops_fma_peak.closed_form(depth * nfma), rtol=1e-4)


def test_fma_probe_plain_equals_host_build_on_random_inputs():
    """Both round once a step; a double rounding in the float64 emulation
    could cost one ulp on a step, hence rtol 1e-5 and not equality."""
    x = torch.from_numpy(np.random.default_rng(0).uniform(0.25, 4.0, 257).astype(np.float32))
    plain = ops_fma_peak.fma_peak_plain(x, 32, 16)
    host = ops_fma_peak.fma_peak_host(x, 32, 16)
    torch.testing.assert_close(plain, host, rtol=1e-5, atol=0)
    # the wrapper takes the plain version for a CPU tensor and counts no launch
    before = launches["fma_peak"]
    torch.testing.assert_close(ops_fma_peak.fma_peak(x, 32, 16), plain, rtol=0, atol=0)
    assert launches["fma_peak"] == before
    # two roundings a step (y * a + b in float32) is a different function
    y = x.clone()
    for _ in range(32 * 16):
        y = y * torch.tensor(ops_fma_peak.A) + torch.tensor(ops_fma_peak.B)
    assert float((y - host).abs().max()) > 0


def test_fma_probe_high_depth_value_near_closed_form():
    """At the probe's depths the value leaves the closed form by the 9-for-
    8.84 ulp rounding drift: -0.14 % and -0.70 %, inside the 2 % the chip
    check allows."""
    for depth, drift in ((1 << 16, -0.0014), (3 << 16, -0.0070)):
        y = float(ops_fma_peak.fma_peak_host(torch.ones(1), depth, 32)[0])
        rel = y / ops_fma_peak.closed_form(depth * 32) - 1.0
        assert abs(rel - drift) < 2e-4


def test_fma_wrapper_refuses_what_the_kernel_does_not_take():
    x = torch.ones(8)
    with pytest.raises(ValueError):
        ops_fma_peak.fma_peak(x, 4, nfma=3)
    with pytest.raises(ValueError):
        ops_fma_peak.fma_peak(x.double(), 4)
    with pytest.raises(ValueError):
        ops_fma_peak.fma_peak(torch.ones(4, 4).T, 4)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            roofline.measure_fma_peak()  # the measurement defaults to the card


def test_measure_fma_peak_report_keys_on_cpu():
    report = roofline.measure_fma_peak(device="cpu", reps=2)
    jax_keys = {"vpu_fma_peak_flops_per_s", "tile", "fma_per_iteration", "depths", "reps",
                "t_lo_s", "t_hi_s"}
    assert jax_keys <= report.keys()
    assert {"fma_peak_flops_per_s", "elements", "chains_per_thread", "block", "grid",
            "value_hi", "closed_form_hi", "share_of_data_sheet_fp32", "device", "card"} \
        <= report.keys()
    assert report["fma_peak_flops_per_s"] == report["vpu_fma_peak_flops_per_s"]
    assert report["device"] == "cpu" and report["card"] is None
    assert report["share_of_data_sheet_fp32"] is None  # no device number from a CPU run
    assert report["depths"] == [2, 6] and report["elements"] == 1024
    np.testing.assert_allclose(report["value_hi"], report["closed_form_hi"], rtol=1e-4)


@pytest.mark.parametrize("t_lo,t_hi,is_none", [(1.0, 1.0, True), (2.0, 1.0, True),
                                               (1.0, 3.0, False)])
def test_marginal_peak_is_none_when_the_deeper_run_was_not_slower(t_lo, t_hi, is_none):
    peak = roofline.marginal_peak(1000, 32, (10, 30), t_lo, t_hi)
    assert (peak is None) == is_none
    if not is_none:
        assert peak == 2.0 * 32 * 1000 * 20 / 2.0


def test_flop_counts_keys_and_ranges():
    c = roofline.flop_counts()
    ref = jroofline.flop_counts()
    assert list(ref) == JAX_KEYS and set(JAX_KEYS) <= set(c)
    for k in ("dynamics_step_flops_deterministic", "dynamics_step_transcendentals_deterministic",
              "dynamics_step_transcendentals", "env_step_transcendentals"):
        assert ref[k] / 2 <= c[k] <= ref[k] * 2, (k, c[k], ref[k])
    for k in ("dynamics_step_flops", "env_step_flops"):
        assert ref[k] / 3 <= c[k] <= ref[k], (k, c[k], ref[k])
    # the ranges of tests/test_roofline.py
    assert 1_000 <= c["dynamics_step_flops"] <= 20_000
    assert c["dynamics_step_flops"] <= c["env_step_flops"] <= 50_000
    assert 1 <= c["dynamics_step_transcendentals"] <= 64
    assert c["env_step_transcendentals"] <= 256
    # the kernels' counts build on the deterministic step
    assert c["rollout_kernel_step_flops"] == c["dynamics_step_flops_deterministic"] + 20
    assert c["eval_kernel_step_flops"] > c["collect_kernel_step_flops"] > 5_000


def test_roofline_main_skip_peak_reads_a_prior_out(tmp_path, capsys):
    out, bench = tmp_path / "roofline.json", tmp_path / "bench.json"
    prior = {"vpu_peak": {"fma_peak_flops_per_s": 5e13, "vpu_fma_peak_flops_per_s": 5e13}}
    out.write_text(json.dumps(prior))
    line = {"detail": {"fused_pallas_rollout": 1e9, "fused_policy_eval": 2e8,
                       "full_env_step_xla": 1e6}}
    bench.write_text("noise\n" + json.dumps(line) + "\n")
    report = roofline.main(["--bench", str(bench), "--out", str(out), "--skip-peak"])
    assert json.loads(capsys.readouterr().out) == report
    assert json.loads(out.read_text()) == report
    assert report["vpu_peak"] == prior["vpu_peak"]
    assert report["fused_rollout_useful_flops_per_s"] == 1e9 * 1082
    np.testing.assert_allclose(report["fused_rollout_vpu_utilization"], 1e9 * 1082 / 5e13)
    np.testing.assert_allclose(report["fused_eval_vpu_utilization"], 2e8 * 5372 / 5e13)
    np.testing.assert_allclose(report["env_step_xla_vpu_utilization"], 1e6 * 2124 / 5e13)
    assert report["fused_rollout_transcendentals_per_s"] == 1e9
    assert "peak_warning" not in report
    # utilization above 1 raises the warning, as in the JAX report
    line["detail"]["fused_pallas_rollout"] = 1e11
    bench.write_text(json.dumps(line) + "\n")
    assert "peak_warning" in roofline.main(
        ["--bench", str(bench), "--out", str(out), "--skip-peak"])
    # without a prior peak there is no utilization, and no failure
    bare = roofline.main(["--bench", str(bench), "--skip-peak"])
    assert bare["vpu_peak"] == {} and "fused_rollout_vpu_utilization" not in bare


def test_roofline_main_measures_on_cpu_when_asked(tmp_path, capsys):
    report = roofline.main(["--device", "cpu", "--out", str(tmp_path / "r.json")])
    capsys.readouterr()
    assert report["backend"] == "cpu" and report["vpu_peak"]["device"] == "cpu"
    assert report["rates_env_steps_per_s"] == {}


def test_roofline_sweep_covers_every_built_fma_count_on_cpu(capsys):
    report = roofline.main(["--device", "cpu", "--sweep"])
    capsys.readouterr()
    sweep = report["fma_peak_sweep"]
    assert sweep["depths"] == [2, 6]
    assert [r["fma_per_iteration"] for r in sweep["by_fma_per_iteration"]] \
        == list(ops_fma_peak.NFMA_BUILT)
    assert [r["elements"] for r in sweep["by_elements"]] == [32, 128, 256, 512, 1027]
    for r in sweep["by_fma_per_iteration"] + sweep["by_elements"]:
        assert set(r) == set(roofline.SWEEP_KEYS) and r["t_lo_s"] > 0 and r["t_hi_s"] > 0
    assert "fma_peak_sweep" not in roofline.main(["--device", "cpu"])
    capsys.readouterr()


def test_bench_small_prints_five_numbers_and_roofline_reads_them(tmp_path):
    """`python -m raptor_tpu_torch.bench --small --device cpu`: one JSON line
    with the JAX bench's keys and five non-null sub-metrics (each from its own
    subprocess); `roofline --bench` turns them into utilizations. The bench
    and its sub-benches run on one thread each: beside the suite's other
    workers, torch's default of one thread a core oversubscribes the host,
    and the sub-benches' thousands of small operations each wait on every
    thread of the pool."""
    proc = subprocess.run(
        [sys.executable, "-m", "raptor_tpu_torch.bench", "--small", "--device", "cpu"],
        capture_output=True, text=True, cwd=ROOT, timeout=600,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert set(line) == {"metric", "value", "unit", "vs_baseline", "detail"}
    detail = line["detail"]
    names = [name for name, _ in bench_module.SUBBENCHES]
    assert names == ["fused_pallas_rollout", "fused_policy_eval", "full_env_step_xla",
                     "train_env_steps_per_s", "pretrain_env_steps_per_s"]
    for name in names:
        assert isinstance(detail[name], int) and detail[name] > 0, (name, detail)
    assert line["value"] == detail["fused_pallas_rollout"] and line["unit"] == "env-steps/s"
    assert detail["small_smoke_mode"] and detail["n_envs"] == 256 and detail["n_steps"] == 64
    assert detail["device"] == "cpu" and detail["card"] is None
    assert detail["target_10M_closed_loop_met"] is False
    # on the CPU the wrappers take their plain versions: no kernel launches
    assert detail["launches"] == {
        name: {"rollout": 0, "eval": 0, "collect": 0, "fma_peak": 0, "bptt": 0} for name in names}
    bench_path, out = tmp_path / "bench.json", tmp_path / "roofline.json"
    bench_path.write_text(proc.stdout)
    out.write_text(json.dumps({"vpu_peak": {"fma_peak_flops_per_s": 6e13}}))
    report = roofline.main(["--bench", str(bench_path), "--out", str(out), "--skip-peak"])
    assert report["rates_env_steps_per_s"]["fused_policy_eval"] == detail["fused_policy_eval"]
    np.testing.assert_allclose(report["fused_rollout_vpu_utilization"],
                               detail["fused_pallas_rollout"] * 1082 / 6e13)


def test_bench_sub_runs_in_process_and_a_failing_sub_gives_null(monkeypatch, capsys):
    out = bench_module.main(["--sub", "fused_pallas_rollout", "--small", "--device", "cpu"])
    assert out["value"] > 0 and json.loads(capsys.readouterr().out.strip()) == out
    assert out["launches"] == {"rollout": 0, "eval": 0, "collect": 0, "fma_peak": 0, "bptt": 0}
    assert bench_module.run_sub(
        "no_such_metric", 60, ["--small", "--device", "cpu"]) == (None, None)
    assert bench_module.N_ENVS == 16384 and bench_module.N_STEPS == 512
    assert bench_module.EVAL_STEPS == 500 and bench_module.TRAIN_GRAD_STEPS == 183
