"""The port's deployment path on the CPU, against the JAX package:

- `checkpoint.code_export` and `checkpoint.rltools_export` write the JAX
  package's headers byte for byte for the same parameters and golden I/O,
  and the committed rl-tools header imports and re-exports byte for byte;
- the export CLI on `.npz` and `.h5`, in both formats, against the JAX CLI
  (each package embeds the golden outputs it replayed itself), and its exit 2
  on the flagship student whose golden output was written on another device;
- `inference.Executor` against the JAX `Executor` at the multi-rate schedule;
- the native executor and the firmware built by the port's `inference.native`
  from a header the port exported: self-tests, parity with the port's
  `Executor`, the timing watchdog, the failsafe latch, a platform adapter, and
  a 500-step software-in-the-loop flight against the port's `L2F`.

The students are committed ones: the JAX package's own tests of this path
need the shipped reference checkpoint, which is not in the repository.
"""

import ctypes
import os
import re
import shutil

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from raptor_tpu.apps import export_policy as jexport_cli
from raptor_tpu.checkpoint import code_export as jcode_export
from raptor_tpu.checkpoint import rltools_export as jrltools
from raptor_tpu.inference import Executor as JExecutor
from raptor_tpu.inference import ExecutorConfig as JExecutorConfig
from raptor_tpu_torch.apps import export_policy
from raptor_tpu_torch.checkpoint import code_export, h5, rltools_export
from raptor_tpu_torch.inference import (
    Executor, ExecutorConfig, Firmware, NativeExecutor, PlatformFirmware, build_executor,
    build_firmware,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PURE_NPZ = os.path.join(ROOT, "raptor_tpu_torch", "data", "student_rateFlagCurPure.npz")
PURE_H5 = os.path.join(ROOT, "artifacts", "student_rateFlagCurPure.h5")
FLAGSHIP_NPZ = os.path.join(ROOT, "raptor_tpu_torch", "data", "student_rateFlagCurMix.npz")
FLAGSHIP_H5 = os.path.join(ROOT, "artifacts", "student_rateFlagCurMix.h5")
RLTOOLS_H = os.path.join(ROOT, "artifacts", "student_r02_rltools_checkpoint.h")
# golden outputs replayed over 500 recurrent steps by the two packages on the
# CPU differ by about 3e-6; the golden I/O bar of tests/test_policy_parity.py
GOLDEN_ATOL = 1e-5

needs_gxx = pytest.mark.skipif(shutil.which("g++") is None, reason="g++ not available")
needs_toolchain = pytest.mark.skipif(
    shutil.which("g++") is None or shutil.which("gcc") is None,
    reason="native toolchain not available")


def _replayed(path):
    """Parameters, golden input and the outputs the port's exporter embeds
    (the input replayed in f32 on the CPU)."""
    params = h5.load_actor(path)
    ei, _ = h5.load_example_io(path)
    return params, ei, export_policy._replay_cpu(params, ei)


@pytest.fixture(scope="module")
def pure():
    return _replayed(PURE_NPZ)


# ------------------------------------------------------------------ headers


@pytest.mark.parametrize("path", [PURE_NPZ, FLAGSHIP_NPZ])
def test_code_export_header_equals_jax_byte_for_byte(path):
    params = h5.load_actor(path)
    ei, eo = h5.load_example_io(path)
    for kw in ({}, {"namespace": "ns_x", "checkpoint_name": "student"}):
        got = code_export.export_header(params, ei, eo, **kw)
        assert got == jcode_export.export_header(params, ei, eo, **kw)
    assert code_export.export_header(params) == jcode_export.export_header(params)


@pytest.mark.parametrize("path", [PURE_NPZ, FLAGSHIP_NPZ])
def test_rltools_header_equals_jax_byte_for_byte(path, tmp_path):
    params = h5.load_actor(path)
    ei, eo = h5.load_example_io(path)
    rltools_export.export_rltools_header(str(tmp_path / "port.h"), params, ei, eo,
                                         name="n", commit_hash="c0ffee")
    jrltools.export_rltools_header(str(tmp_path / "jax.h"), params, ei, eo,
                                   name="n", commit_hash="c0ffee")
    assert (tmp_path / "port.h").read_bytes() == (tmp_path / "jax.h").read_bytes()
    got, gi, go = rltools_export.import_rltools_header(str(tmp_path / "port.h"))
    for layer, tensors in params.items():  # the names checkpoint.from_numpy takes
        for k, v in tensors.items():
            np.testing.assert_array_equal(got[layer][k].reshape(v.shape), v)
    np.testing.assert_array_equal(gi, ei)
    np.testing.assert_array_equal(go, eo)


def test_committed_rltools_header_imports_and_reexports_byte_for_byte(tmp_path):
    got, gi, go = rltools_export.import_rltools_header(RLTOOLS_H)
    want, wi, wo = jrltools.import_rltools_header(RLTOOLS_H)
    for layer in want:
        for k in want[layer]:
            np.testing.assert_array_equal(got[layer][k], want[layer][k])
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(go, wo)
    assert got["gru_1"]["weights_input"].shape == (48, 16) and gi.shape == (500, 2, 22)
    out = tmp_path / "checkpoint.h"
    rltools_export.export_rltools_header(str(out), got, gi, go,
                                         name="artifacts/student_640teachers.h5")
    with open(RLTOOLS_H, "rb") as f:
        assert out.read_bytes() == f.read()


# ---------------------------------------------------------------- the CLI


def _raptor_header_arrays(text):
    """The EXAMPLE_OUTPUT array of a raptor-format header, and the text
    without it."""
    m = re.search(r"EXAMPLE_OUTPUT\[\d+\]\[\d+\]\[\d+\] = \{([^}]*)\};", text)
    values = np.array([float(v.rstrip("f")) for v in m.group(1).split(",")], np.float32)
    return values, text[:m.start(1)] + text[m.end(1):]


@pytest.mark.parametrize("fmt", ["raptor", "rltools"])
@pytest.mark.parametrize("ckpt", [PURE_NPZ, PURE_H5])
def test_export_cli_matches_the_jax_cli(ckpt, fmt, tmp_path, capsys):
    port_h, jax_h = tmp_path / "port.h", tmp_path / "jax.h"
    name = ["--name", "student"]
    export_policy.main([ckpt, str(port_h), "--format", fmt, *name])
    line = capsys.readouterr().out.strip()
    jexport_cli.main([PURE_H5, str(jax_h), "--format", fmt, *name])
    jline = capsys.readouterr().out.strip()
    assert line.split("  ")[1] == jline.split("  ")[1] == f"format={fmt}"
    drift = float(line.split("drift: ")[1])
    assert abs(drift - float(jline.split("drift: ")[1])) < 1e-5 and drift < 1e-3
    if fmt == "rltools":
        assert float(line.split("max-err: ")[1].split()[0]) < 1e-5
        got, gi, go = rltools_export.import_rltools_header(str(port_h))
        want, wi, wo = jrltools.import_rltools_header(str(jax_h))
        for layer in want:
            for k in want[layer]:
                np.testing.assert_array_equal(got[layer][k], want[layer][k])
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_allclose(go, wo, atol=GOLDEN_ATOL, rtol=0)
    else:
        got, rest = _raptor_header_arrays(port_h.read_text())
        want, jrest = _raptor_header_arrays(jax_h.read_text())
        assert rest == jrest  # weights and golden input byte for byte
        np.testing.assert_allclose(got, want, atol=GOLDEN_ATOL, rtol=0)


def test_export_cli_refuses_the_flagship_as_jax_does(tmp_path, capsys):
    """The flagship's golden output was written on another device: replayed on
    the CPU both packages miss it by more than 1e-3 and exit 2."""
    for cli, ckpt in ((export_policy, FLAGSHIP_NPZ), (jexport_cli, FLAGSHIP_H5)):
        with pytest.raises(SystemExit) as e:
            cli.main([ckpt, str(tmp_path / "x.h")])
        assert e.value.code == 2
        assert "drift 1.1" in capsys.readouterr().err
    assert not (tmp_path / "x.h").exists()


# ------------------------------------------------------------ executors


def _drive(ex, times_us, observations):
    return [ex.control(t, o) for t, o in zip(times_us, observations)]


def test_executor_matches_jax_executor_at_the_multirate_schedule(pure):
    """400 Hz calls, the GRU state committed every fourth: actions to 1e-5
    and equal status bitmasks over 200 golden inputs."""
    params, ei, _ = pure
    times = [2500 * i for i in range(200)]
    got = _drive(Executor(params, ExecutorConfig(), device="cpu"), times, ei[:200, 0])
    with jax.default_matmul_precision("highest"):
        want = _drive(JExecutor(params, JExecutorConfig()), times, ei[:200, 0])
    np.testing.assert_allclose(np.stack([a for a, _ in got]), np.stack([a for a, _ in want]),
                               atol=1e-5, rtol=0)
    assert [s for _, s in got] == [s for _, s in want] == [0] * 200
    assert np.all(np.abs(np.stack([a for a, _ in got])) <= 1.0)


def test_executor_takes_tensor_params_and_commits_every_fourth_call(pure):
    params, ei, _ = pure
    ex = Executor({layer: {k: torch.from_numpy(v) for k, v in t.items()}
                   for layer, t in params.items()}, device="cpu")
    outs = [ex.control(i * 2500, ei[0, 0])[0] for i in range(8)]
    # intra-native-interval outputs are constant: the hidden state holds
    np.testing.assert_array_equal(outs[1], outs[2])
    np.testing.assert_array_equal(outs[1], outs[3])
    assert np.max(np.abs(outs[0] - outs[4])) > 1e-6 or np.max(np.abs(outs[4] - outs[7])) > 1e-7
    assert ex.hidden.device.type == "cpu" and ex.call_count == 8


def test_executor_timing_levels_and_first_interval_as_jax(pure):
    """The first interval is watched from t = 0, and the warning levels
    follow the JAX executor's, call for call."""
    params, *_ = pure
    obs = np.zeros(22, np.float32)
    for times, last in (([0, 12_000], 1 << 2),
                        ([0, 2500, 2500 + 2700, 2500 + 2700 + 6000], 1 << 2)):
        ex, jex = Executor(params, device="cpu"), JExecutor(params)
        got = [s for _, s in _drive(ex, times, [obs] * len(times))]
        assert got == [s for _, s in _drive(jex, times, [obs] * len(times))]
        assert got[0] == 0 and got[-1] & last
        assert ex.timing_stats() == pytest.approx(jex.timing_stats())
    assert got[1] == 0 and got[2] & 1  # on time, then ~8 % late: level 1
    assert Executor(params, device="cpu").timing_stats() == (0.0, 0.0)


@pytest.fixture(scope="module")
def header(tmp_path_factory, pure):
    params, ei, eo_local = pure
    path = tmp_path_factory.mktemp("export") / "policy_checkpoint.h"
    code_export.export_header_file(str(path), params, ei, eo_local, checkpoint_name="pure")
    return str(path)


@pytest.fixture(scope="module")
def native(header):
    if shutil.which("g++") is None:
        pytest.skip("g++ not available")
    return NativeExecutor(build_executor(header))


@needs_gxx
def test_native_self_test_and_build_cache(native, header):
    assert native.self_test() <= 1e-4
    so = build_executor(header)
    assert os.path.dirname(so).endswith(os.path.join(".cache", "native_torch"))
    assert build_executor(header) == so  # cached by content
    assert not [n for n in os.listdir(os.path.dirname(so)) if n.startswith(".build_")]


@needs_gxx
def test_native_matches_the_port_executor(native, pure):
    params, ei, eo_local = pure
    native.configure()
    native.reset()
    py = Executor(params, ExecutorConfig(), device="cpu")
    times = [2500 * i for i in range(64)]
    for (a_n, s_n), (a_p, s_p) in zip(_drive(native, times, ei[:64, 0]),
                                      _drive(py, times, ei[:64, 0])):
        np.testing.assert_allclose(a_n, a_p, atol=1e-5, rtol=0)
        assert s_n == s_p == 0
    assert native.call_count == 64
    # at the native rate (100 Hz, every call commits) the golden sequence replays
    native.configure(intermediate_ns=10_000_000, force_sync_native=1)
    native.reset()
    errs = [np.max(np.abs(native.control(t * 10_000, ei[t, 0])[0] - np.clip(eo_local[t, 0], -1, 1)))
            for t in range(100)]
    native.configure()
    assert max(errs) <= 1e-4


@needs_gxx
def test_native_timing_watchdog(native):
    native.configure()
    native.reset()
    obs = np.zeros(22, np.float32)
    assert native.control(0, obs)[1] == 0
    assert native.control(12_000, obs)[1] & NativeExecutor.STATUS_TIMING_L3
    assert native.timing_stats()[0] == 12_000_000.0
    native.reset()
    native.control(0, obs)
    assert native.control(2500, obs)[1] == 0
    assert native.control(2500 + 2700, obs)[1] & NativeExecutor.STATUS_TIMING_L1
    assert native.control(2500 + 2700 + 6000, obs)[1] & NativeExecutor.STATUS_TIMING_L3
    assert native.timing_stats()[1] >= 6000 * 1000


# ------------------------------------------------------------- firmware


@pytest.fixture(scope="module")
def firmware_so(header):
    if shutil.which("g++") is None or shutil.which("gcc") is None:
        pytest.skip("native toolchain not available")
    return build_firmware(header)


def _instance(so, tmp_path, name):
    """A second copy of the library: each path loads its own firmware state."""
    path = tmp_path / name
    shutil.copy(so, path)
    return str(path)


@needs_toolchain
def test_firmware_boots_and_refuses_to_fly_before_boot(firmware_so, tmp_path):
    lib = ctypes.CDLL(_instance(firmware_so, tmp_path, "unbooted.so"))
    lib.raptor_fw_step.restype = ctypes.c_int
    est, thr = np.zeros(13, np.float32), np.ones(4, np.float32)
    fp = ctypes.POINTER(ctypes.c_float)
    status = lib.raptor_fw_step(ctypes.c_uint64(0), est.ctypes.data_as(fp), thr.ctypes.data_as(fp))
    assert status == Firmware.NOT_BOOTED
    np.testing.assert_array_equal(thr, 0.0)
    assert Firmware(firmware_so).boot_status == Firmware.OK


@needs_toolchain
def test_firmware_timing_fault_latches_until_reset(firmware_so, tmp_path):
    fw = Firmware(_instance(firmware_so, tmp_path, "latch.so"))
    assert fw.boot_status == Firmware.OK
    pos, quat, vel = np.zeros(3, np.float32), np.array([1, 0, 0, 0], np.float32), np.zeros(3)
    assert fw.step(0, pos, quat, vel, vel)[1] == Firmware.OK
    for t_us in (1_000_000, 1_002_500):  # 400x the contract, then on time: latched
        thr, status = fw.step(t_us, pos, quat, vel, vel)
        assert status == Firmware.FAILSAFE
        np.testing.assert_array_equal(thr, 0.0)
    fw.reset()
    assert fw.step(1_005_000, pos, quat, vel, vel)[1] == Firmware.OK


@needs_toolchain
def test_px4_adapter_equals_the_direct_path(firmware_so, tmp_path):
    """NED/FRD-converted state through the PX4 adapter reproduces the direct
    FLU control task after un-mapping PWM (after
    tests/test_firmware_platforms.py)."""
    direct = Firmware(_instance(firmware_so, tmp_path, "direct.so"))
    px4 = PlatformFirmware(_instance(firmware_so, tmp_path, "px4.so"), PlatformFirmware.PX4)
    assert direct.boot_status == px4.boot_status == Firmware.OK
    px4.arm()
    assert px4.armed
    flip = np.array([1.0, -1.0, -1.0], np.float32)
    rng = np.random.default_rng(3)
    for i in range(20):
        pos, vel, gyro = (rng.normal(0, s, 3).astype(np.float32) for s in (0.2, 0.3, 0.5))
        q = rng.normal(0, 1, 4).astype(np.float32)
        q /= np.linalg.norm(q)
        thr, st_a = direct.step(2500 * i, pos, q, vel, gyro)
        pwm, st_b = px4.step(2500 * i, pos * flip, np.array([q[0], q[1], -q[2], -q[3]]),
                             vel * flip, gyro * flip)
        assert st_a == st_b == Firmware.OK
        np.testing.assert_allclose(((pwm - 1000.0) / 1000.0 - 0.05) / 0.95, thr, atol=1e-5)


@needs_toolchain
def test_sitl_flight_500_steps_against_the_port_env(firmware_so, tmp_path):
    """The firmware flies a crazyflie in the port's simulator for a 500-step
    episode from attitudes up to 0.5 rad: 4 firmware calls a 10 ms step,
    throttle mapped back to the [-1, 1] motor frame; no failsafe, no
    termination, inside 5 m at the end (the bar of tests/test_firmware_sitl.py)."""
    fw = Firmware(_instance(firmware_so, tmp_path, "sitl.so"))
    assert fw.boot_status == Firmware.OK
    # the flight of chip_smoke.py's phase 15, here on the CPU
    assert chip_smoke.sitl_flight(torch, fw, torch.device("cpu"), steps=500) < 5.0
