"""Build and load the port's native code from `raptor_tpu_torch/csrc/`.

- `cuda_library()`: the CUDA kernels (`rollout.cu`, `eval.cu`, `collect.cu`,
  `fma_peak.cu`), each source compiled by its own `nvcc` process (all started together) for
  sm_90a, then linked into one shared library with a plain C interface, loaded
  with ctypes.
- `host_library()`: `host_shim.cpp`, the kernels' per-env code looped on the
  CPU, built with g++ for the CPU tests.

Both are built at first use into `build/raptor_tpu_torch/` beside the
package, under a name that hashes the sources and flags, so an edited source
is never served by a stale library. No `--use_fast_math`: `expf`, `tanhf`,
`sqrtf` and the divisions stay IEEE-accurate.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "raptor_tpu_torch"
HEADERS = ("quad_step.cuh", "fma_chain.cuh")
CUDA_SOURCES = ("rollout.cu", "eval.cu", "collect.cu", "fma_peak.cu")
HOST_SOURCE = "host_shim.cpp"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_P, _I, _F, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint32
_L = ctypes.c_long
# pointers..., n, n_steps, dt, pos_bound, linvel_bound, angvel_bound
ROLLOUT_ARGS = [_P] * 5 + [_I, _I] + [_F] * 4
# weights, params, state, out, stats, n, n_steps, dt, bounds(3), reward(7)
EVAL_ARGS = [_P] * 5 + [_I, _I] + [_F] * 4 + [_F] * 7
# position_range, max_angle, angle_power, linear/angular velocity std, rpm_at_hover
INIT_ARGS = [_F] * 5 + [_I]
# weights, params, state, out, n, n_steps, dt, episode_length, bounds(3),
# init(6), seed, env_offset
COLLECT_ARGS = [_P] * 4 + [_I, _I] + [_F] * 5 + INIT_ARGS + [_U, _U]
# x, out, n, depth, nfma, a, b
FMA_PEAK_ARGS = [_P, _P, _L, _I, _I, _F, _F]

_lock = threading.Lock()
_loaded: dict = {}


def _tag(sources, flags) -> str:
    h = hashlib.sha256()
    for name in (*HEADERS, *sources):
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(flags).encode())
    return h.hexdigest()[:16]


def _run(cmd) -> str:
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode:
        raise RuntimeError(f"build failed: {' '.join(map(str, cmd))}\n{proc.stdout}")
    return proc.stdout


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(cuda_home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME to the CUDA toolkit)")


def _build_cuda(lib: Path) -> None:
    nvcc = nvcc_path()
    tmp = f".{os.getpid()}"
    objs = [lib.with_name(f"{lib.stem}.{src}{tmp}.o") for src in CUDA_SOURCES]
    procs = [
        subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(CSRC / src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for src, obj in zip(CUDA_SOURCES, objs)
    ]
    logs = [p.communicate()[0] for p in procs]
    failed = [src for src, p in zip(CUDA_SOURCES, procs) if p.returncode]
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
    log = "".join(logs) + _run([nvcc, "-shared", "-o", str(lib) + tmp, *map(str, objs)])
    for obj in objs:
        obj.unlink()
    lib.with_suffix(".log").write_text(log)
    os.replace(str(lib) + tmp, lib)


def _build_host(lib: Path) -> None:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found")
    tmp = str(lib) + f".{os.getpid()}"
    _run([gxx, *GXX_FLAGS, "-o", tmp, str(CSRC / HOST_SOURCE)])
    os.replace(tmp, lib)


def _load(kind: str, sources, flags, build, signatures) -> ctypes.CDLL:
    with _lock:
        if kind not in _loaded:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            lib = BUILD_DIR / f"lib{kind}_{_tag(sources, flags)}.so"
            if not lib.exists():
                build(lib)
            dll = ctypes.CDLL(str(lib))
            for name, argtypes in signatures.items():
                fn = getattr(dll, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _loaded[kind] = (dll, lib)
        return _loaded[kind][0]


def cuda_library() -> ctypes.CDLL:
    """The CUDA kernels, built on first call. Entry points `raptor_rollout`,
    `raptor_eval`, `raptor_collect` and `raptor_fma_peak` (which also fills an
    int[3] with its chains a thread, block and grid) take a stream last and
    return cudaGetLastError()."""
    return _load(
        "raptor_cuda", CUDA_SOURCES, NVCC_FLAGS, _build_cuda,
        {
            "raptor_rollout": ROLLOUT_ARGS + [_P],
            "raptor_eval": EVAL_ARGS + [_P],
            "raptor_collect": COLLECT_ARGS + [_P],
            "raptor_fma_peak": FMA_PEAK_ARGS + [_P, _P],
        },
    )


def cuda_build_log() -> str:
    """nvcc's output for the loaded CUDA library (ptxas registers and spills)."""
    cuda_library()
    return _loaded["raptor_cuda"][1].with_suffix(".log").read_text()


def cuda_sass_counts(kernel: str):
    """(FFMA instructions, all instructions) in the SASS of the loaded CUDA
    library's first function whose mangled name contains `kernel`, from
    `cuobjdump -sass`; None where the toolkit has no cuobjdump."""
    cuda_library()
    cuobjdump = os.path.join(os.path.dirname(nvcc_path()), "cuobjdump")
    if not os.path.exists(cuobjdump):
        return None
    n_ffma = n_all = 0
    inside = False
    for line in _run([cuobjdump, "-sass", str(_loaded["raptor_cuda"][1])]).splitlines():
        if "Function :" in line:
            if inside:
                break
            inside = kernel in line
        elif inside and line.lstrip().startswith("/*") and ";" in line:
            n_all += 1
            n_ffma += " FFMA " in line
    return n_ffma, n_all


def host_library() -> ctypes.CDLL:
    """The kernels' per-env code built for the CPU (`raptor_rollout_host`,
    `raptor_eval_host`, `raptor_collect_host`, `raptor_fma_peak_host`: the CUDA
    entry points without the stream (and the geometry); `raptor_hash_host` and `raptor_sample_state_host`: the collect
    kernel's PRNG and sampler on arrays of counters)."""
    return _load(
        "raptor_host", (HOST_SOURCE,), GXX_FLAGS, _build_host,
        {
            "raptor_rollout_host": ROLLOUT_ARGS,
            "raptor_eval_host": EVAL_ARGS,
            "raptor_collect_host": COLLECT_ARGS,
            "raptor_fma_peak_host": FMA_PEAK_ARGS,
            "raptor_hash_host": [_P, _P, _P, _I, _U],
            "raptor_sample_state_host": [_P, _P, _P, _I] + INIT_ARGS,
        },
    )
