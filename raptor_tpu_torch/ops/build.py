"""Build and load the port's native code from `raptor_tpu_torch/csrc/`.

- `cuda_library()`: the CUDA kernels (`rollout.cu`, `eval.cu`, `collect.cu`,
  `bptt.cu`, `fma_peak.cu`; the eval, collect and BPTT sources once for each
  hidden width in `HIDDEN_WIDTHS`), each unit compiled by its own `nvcc` process (all started
  together) for sm_90a, then linked into one shared library with a plain C
  interface, loaded with ctypes.
- `host_library()`: `host_shim.cpp`, the kernels' per-env code looped on the
  CPU (a team's lanes phase by phase), built with g++ for the CPU tests.

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
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "raptor_tpu_torch"
HEADERS = ("quad_step.cuh", "team_step.cuh", "fma_chain.cuh", "bptt_step.cuh")
# the hidden widths the eval, collect and BPTT kernels are built for: one
# object a width, exporting raptor_eval_<H>, raptor_collect_<H> and
# raptor_bptt_{forward,backward}_<H>
HIDDEN_WIDTHS = (8, 16, 24, 32, 48)
CUDA_SOURCES = ("rollout.cu", "eval.cu", "collect.cu", "bptt.cu", "fma_peak.cu")
# (source, extra nvcc flags) of each object
CUDA_UNITS = (
    ("rollout.cu", ()), ("fma_peak.cu", ()),
    *((src, (f"-DRAPTOR_HIDDEN={h}",)) for src in ("eval.cu", "collect.cu", "bptt.cu")
      for h in HIDDEN_WIDTHS),
)
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
# weights, params, state, out, stats, n, n_steps, dt, bounds(3), reward(7);
# the host shim's takes the hidden width after n_steps
EVAL_ARGS = [_P] * 5 + [_I, _I] + [_F] * 4 + [_F] * 7
# position_range, max_angle, angle_power, linear/angular velocity std, rpm_at_hover
INIT_ARGS = [_F] * 5 + [_I]
# weights, params, state, out, n, n_steps, dt, episode_length, bounds(3),
# init(6), seed, env_offset; the host shim's takes the hidden width after n_steps
COLLECT_ARGS = [_P] * 4 + [_I, _I] + [_F] * 5 + INIT_ARGS + [_U, _U]
# x, out, n, depth, nfma, a, b
FMA_PEAK_ARGS = [_P, _P, _L, _I, _I, _F, _F]
# the student's nine leaves, obs, reset
BPTT_IN = [_P] * 11
# ..., actions, saved, n_steps, batch
BPTT_FORWARD_ARGS = BPTT_IN + [_P, _P, _I, _I]
# ..., saved, d_actions, partial, grad, n_steps, batch
BPTT_BACKWARD_ARGS = BPTT_IN + [_P] * 4 + [_I, _I]
# ..., d_actions, actions, grad, n_steps, batch, hidden
BPTT_HOST_ARGS = BPTT_IN + [_P] * 3 + [_I, _I, _I]

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
    objs = [lib.with_name(f"{lib.stem}.{k}{tmp}.o") for k in range(len(CUDA_UNITS))]
    t0 = time.perf_counter()
    procs = [
        subprocess.Popen(
            [nvcc, *NVCC_FLAGS, *defs, "-c", str(CSRC / src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for (src, defs), obj in zip(CUDA_UNITS, objs)
    ]
    seconds = [None] * len(procs)
    while None in seconds:  # note when each unit finishes
        for k, proc in enumerate(procs):
            if seconds[k] is None and proc.poll() is not None:
                seconds[k] = time.perf_counter() - t0
        time.sleep(0.05)
    logs = [
        f"unit {src} {' '.join(defs)}: {sec:.1f} s\n" + p.communicate()[0]
        for (src, defs), sec, p in zip(CUDA_UNITS, seconds, procs)
    ]
    failed = [unit for unit, p in zip(CUDA_UNITS, procs) if p.returncode]
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
    `raptor_eval_<H>`, `raptor_collect_<H>`, `raptor_bptt_forward_<H>` and
    `raptor_bptt_backward_<H>` for H in `HIDDEN_WIDTHS`, and
    `raptor_fma_peak` (which also fills an int[3] with its chains a thread,
    block and grid) take a stream last and return cudaGetLastError();
    `raptor_rollout_threads_per_env`, `raptor_eval_lanes_<H>` and
    `raptor_collect_threads_per_env_<H>` return the lanes of a team, and
    `raptor_eval_envs_<H>` the envs an eval team flies."""
    units = " ".join(f"{src}{''.join(defs)}" for src, defs in CUDA_UNITS)
    return _load(
        "raptor_cuda", CUDA_SOURCES, (*NVCC_FLAGS, units), _build_cuda,
        {
            "raptor_rollout": ROLLOUT_ARGS + [_P],
            **{f"raptor_eval_{h}": EVAL_ARGS + [_P] for h in HIDDEN_WIDTHS},
            **{f"raptor_collect_{h}": COLLECT_ARGS + [_P] for h in HIDDEN_WIDTHS},
            **{f"raptor_bptt_forward_{h}": BPTT_FORWARD_ARGS + [_P] for h in HIDDEN_WIDTHS},
            **{f"raptor_bptt_backward_{h}": BPTT_BACKWARD_ARGS + [_P] for h in HIDDEN_WIDTHS},
            "raptor_fma_peak": FMA_PEAK_ARGS + [_P, _P],
            "raptor_rollout_threads_per_env": [],
            **{f"raptor_eval_lanes_{h}": [] for h in HIDDEN_WIDTHS},
            **{f"raptor_eval_envs_{h}": [] for h in HIDDEN_WIDTHS},
            **{f"raptor_collect_threads_per_env_{h}": [] for h in HIDDEN_WIDTHS},
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
    entry points without the stream (and the geometry), the eval and collect
    ones with the hidden width after n_steps (-1 for one not built);
    `raptor_collect_team_host`: the collect at hidden width 16 with the lanes
    of a team (1, 2, 4 or 8) in the width's place; `raptor_eval_unblocked_host`:
    `raptor_eval_host` with one env a team, and `raptor_eval_envs_host(hidden)`
    the envs a team of `raptor_eval_host`; `raptor_bptt_host`: the
    BPTT's forward, backward and gradient sum in one call, the hidden width
    last; `raptor_hash_host` and
    `raptor_sample_state_host`: the collect kernel's PRNG and sampler on
    arrays of counters)."""
    return _load(
        "raptor_host", (HOST_SOURCE,), GXX_FLAGS, _build_host,
        {
            "raptor_rollout_host": ROLLOUT_ARGS,
            "raptor_eval_host": EVAL_ARGS[:7] + [_I] + EVAL_ARGS[7:],
            "raptor_eval_unblocked_host": EVAL_ARGS[:7] + [_I] + EVAL_ARGS[7:],
            "raptor_eval_envs_host": [_I],
            "raptor_collect_host": COLLECT_ARGS[:6] + [_I] + COLLECT_ARGS[6:],
            "raptor_collect_team_host": COLLECT_ARGS[:6] + [_I] + COLLECT_ARGS[6:],
            "raptor_fma_peak_host": FMA_PEAK_ARGS,
            "raptor_bptt_host": BPTT_HOST_ARGS,
            "raptor_hash_host": [_P, _P, _P, _I, _U],
            "raptor_sample_state_host": [_P, _P, _P, _I] + INIT_ARGS,
        },
    )
