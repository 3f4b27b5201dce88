"""Build + ctypes binding for the native (C++) inference executor and the
firmware control task.

Taken from `raptor_tpu/inference/native.py` (numpy and ctypes only), so the
port never imports the JAX package; every executor and firmware boot here runs
its golden-I/O self-test. Pipeline: export the policy to a standalone
C++ header (`checkpoint.code_export`), compile the shared
`native/executor.cpp` (and, for the firmware, `native/firmware/`) against it
with g++ and gcc into a shared library, and drive it through ctypes: the
artifact chain of a firmware deployment (policy header + executor + C ABI),
run on the host.

Libraries go to `.cache/native_torch/` under the repository root, and only
there, keyed by a hash of every compiled source. Each build writes into a
fresh temporary directory beside the target and moves the library into place
with `os.replace`, so two processes building the same library at once (test
workers, for example) never load a half-written file. g++ and gcc are
required: a missing compiler raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_EXECUTOR_CPP = os.path.join(_REPO_ROOT, "native", "executor.cpp")
_FIRMWARE_DIR = os.path.join(_REPO_ROOT, "native", "firmware")
_BUILD_DIR = os.path.join(_REPO_ROOT, ".cache", "native_torch")


def _content_tag(*paths: str) -> str:
    """Cache key over ALL compiled sources (a stale .so keyed only on the
    policy header would silently ignore executor/firmware C edits)."""
    h = hashlib.sha256()
    for p in paths:
        with open(p, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _compiler(name: str) -> str:
    path = shutil.which(name)
    if path is None:
        raise RuntimeError(f"{name} not found on PATH: the native executor and firmware "
                           "are built with g++ and gcc")
    return path


def _build(so_path: str, steps) -> str:
    """Run `steps(tmp_dir) -> built .so path` in a temporary directory beside
    `so_path`, then move the library into place."""
    out_dir = os.path.dirname(os.path.abspath(so_path))
    os.makedirs(out_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir, prefix=".build_") as tmp:
        os.replace(steps(tmp), so_path)
    return so_path


def _run(cmd) -> None:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed:\n{proc.stderr}")


def build_executor(policy_header_path: str) -> str:
    """Compile the executor against a generated policy header; returns the
    .so path (cached by content hash)."""
    gxx = _compiler("g++")
    tag = _content_tag(policy_header_path, _EXECUTOR_CPP)
    so_path = os.path.join(_BUILD_DIR, f"libraptor_executor_{tag}.so")
    if os.path.exists(so_path):
        return so_path

    def steps(tmp):
        lib = os.path.join(tmp, "executor.so")
        _run([gxx, "-O2", "-shared", "-fPIC", "-std=c++17",
              "-include", os.path.abspath(policy_header_path), _EXECUTOR_CPP, "-o", lib])
        return lib

    return _build(so_path, steps)


def build_firmware(policy_header_path: str) -> str:
    """Compile the firmware control task (C99, `native/firmware/`) together
    with the inference executor against a generated policy header: policy
    header + inference executor + firmware-side control task (obs assembly,
    mixer de-normalization, boot self-test, failsafe) and the platform
    adapters, built on the host so a software-in-the-loop run can fly it
    against the simulator."""
    gcc, gxx = _compiler("gcc"), _compiler("g++")
    task_c = os.path.join(_FIRMWARE_DIR, "raptor_control_task.c")
    task_h = os.path.join(_FIRMWARE_DIR, "raptor_control_task.h")
    platform_c = os.path.join(_FIRMWARE_DIR, "raptor_platform.c")
    platform_h = os.path.join(_FIRMWARE_DIR, "raptor_platform.h")
    tag = _content_tag(policy_header_path, _EXECUTOR_CPP, task_c, task_h,
                       platform_c, platform_h)
    so_path = os.path.join(_BUILD_DIR, f"libraptor_firmware_{tag}.so")
    if os.path.exists(so_path):
        return so_path

    def steps(tmp):
        objs = [os.path.join(tmp, n) for n in ("task.o", "platform.o", "exec.o")]
        # the control task + platform adapters are firmware-grade C99 (-Os,
        # static allocation only); the executor is C++17 carrying the policy
        for src, obj in ((task_c, objs[0]), (platform_c, objs[1])):
            _run([gcc, "-Os", "-std=c99", "-fPIC", "-I", _FIRMWARE_DIR, "-c", src, "-o", obj])
        _run([gxx, "-O2", "-std=c++17", "-fPIC", "-include",
              os.path.abspath(policy_header_path), "-c", _EXECUTOR_CPP, "-o", objs[2]])
        lib = os.path.join(tmp, "firmware.so")
        _run([gxx, "-shared", *objs, "-o", lib])
        return lib

    return _build(so_path, steps)


class Firmware:
    """ctypes wrapper over the compiled firmware control task (SITL side)."""

    OK, SELF_TEST_FAILED, NOT_BOOTED, FAILSAFE = 0, 1, 2, 3

    def __init__(self, so_path: str):
        self.lib = ctypes.CDLL(so_path)
        self.lib.raptor_fw_boot.argtypes = [ctypes.c_int]
        self.lib.raptor_fw_boot.restype = ctypes.c_int
        self.lib.raptor_fw_step.argtypes = [
            ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float),
        ]
        self.lib.raptor_fw_step.restype = ctypes.c_int
        self.boot_status = self.lib.raptor_fw_boot(0)  # 0: run the boot self-test

    def step(
        self,
        time_us: int,
        position: np.ndarray,
        orientation_wxyz: np.ndarray,
        linear_velocity: np.ndarray,
        angular_velocity: np.ndarray,
    ) -> tuple[np.ndarray, int]:
        """One control-loop call; returns ([4] throttle in [0,1], status)."""
        est = np.concatenate(
            [position, orientation_wxyz, linear_velocity, angular_velocity]
        ).astype(np.float32)
        throttle = np.zeros(4, np.float32)
        status = self.lib.raptor_fw_step(
            int(time_us),
            est.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            throttle.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
        return throttle, status

    def reset(self):
        self.lib.raptor_fw_reset()


class PlatformFirmware:
    """ctypes wrapper over the platform-adapter layer (raptor_platform.h):
    the reference's embedded_platforms/ integrations (PX4 / Betaflight /
    Crazyflie / M5StampFly, reference README:107-110) driven SITL in each
    platform's own frame/unit/motor conventions."""

    PX4, BETAFLIGHT, CRAZYFLIE, M5STAMPFLY = 0, 1, 2, 3

    def __init__(self, so_path: str, platform: int):
        self.lib = ctypes.CDLL(so_path)
        self.lib.raptor_platform_boot.argtypes = [ctypes.c_int, ctypes.c_int]
        self.lib.raptor_platform_boot.restype = ctypes.c_int
        self.lib.raptor_platform_step.argtypes = [
            ctypes.c_uint64] + [ctypes.POINTER(ctypes.c_float)] * 5
        self.lib.raptor_platform_step.restype = ctypes.c_int
        self.lib.raptor_platform_is_armed.restype = ctypes.c_int
        self.boot_status = self.lib.raptor_platform_boot(platform, 0)  # with the self-test

    def arm(self):
        self.lib.raptor_platform_arm()

    @property
    def armed(self) -> bool:
        return bool(self.lib.raptor_platform_is_armed())

    def step(
        self,
        time_us: int,
        position: np.ndarray,
        quat: np.ndarray,
        velocity: np.ndarray,
        gyro: np.ndarray,
    ) -> tuple[np.ndarray, int]:
        """One call in the PLATFORM's conventions; returns ([4] motor
        outputs in the platform's range/order, status)."""
        fp = ctypes.POINTER(ctypes.c_float)
        arrs = [np.ascontiguousarray(a, np.float32)
                for a in (position, quat, velocity, gyro)]
        motor = np.zeros(4, np.float32)
        status = self.lib.raptor_platform_step(
            int(time_us), *(a.ctypes.data_as(fp) for a in arrs),
            motor.ctypes.data_as(fp),
        )
        return motor, status


class NativeExecutor:
    """ctypes wrapper over the compiled executor shared library."""

    STATUS_TIMING_L1 = 1 << 0
    STATUS_TIMING_L2 = 1 << 1
    STATUS_TIMING_L3 = 1 << 2
    STATUS_SELF_TEST_FAILED = 1 << 3

    def __init__(self, so_path: str):
        self.lib = ctypes.CDLL(so_path)
        self.lib.raptor_inference_init.argtypes = [ctypes.c_int]
        self.lib.raptor_inference_init.restype = ctypes.c_int
        self.lib.raptor_inference_l2f_control.argtypes = [
            ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float),
        ]
        self.lib.raptor_inference_l2f_control.restype = ctypes.c_int
        self.lib.raptor_inference_self_test.restype = ctypes.c_float
        self.lib.raptor_inference_timing_stats.argtypes = [
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double),
        ]
        self.lib.raptor_inference_call_count.restype = ctypes.c_uint64
        self.lib.raptor_inference_configure.argtypes = [
            ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint32, ctypes.c_uint32,
        ]
        status = self.lib.raptor_inference_init(0)  # 0: run the golden-I/O self-test
        if status:
            raise RuntimeError(f"native executor init failed: status={status}")

    def configure(
        self,
        intermediate_ns: int = 2_500_000,
        native_ns: int = 10_000_000,
        force_sync_native: int = 4,
        timing_window: int = 100,
    ):
        self.lib.raptor_inference_configure(
            intermediate_ns, native_ns, force_sync_native, timing_window
        )

    def reset(self):
        self.lib.raptor_inference_reset()

    def control(self, time_us: int, observation: np.ndarray) -> tuple[np.ndarray, int]:
        obs = np.ascontiguousarray(observation, np.float32)
        action = np.zeros(4, np.float32)
        status = self.lib.raptor_inference_l2f_control(
            int(time_us),
            obs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            action.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
        return action, status

    def self_test(self) -> float:
        return float(self.lib.raptor_inference_self_test())

    def timing_stats(self) -> tuple[float, float]:
        mean = ctypes.c_double()
        mx = ctypes.c_double()
        self.lib.raptor_inference_timing_stats(
            ctypes.byref(mean), ctypes.byref(mx)
        )
        return mean.value, mx.value

    @property
    def call_count(self) -> int:
        return int(self.lib.raptor_inference_call_count())
