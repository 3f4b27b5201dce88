"""FP32 fused-multiply-add peak probe: every element of an f32 array goes
through `depth` x `nfma` dependent `y = fma(y, a, b)` steps in one CUDA
kernel (`csrc/fma_peak.cu`).

Counterpart of the Pallas kernel inside
`raptor_tpu/apps/roofline.py:measure_vpu_peak`. `apps/roofline.py` times it at
two depths; the marginal time between them gives the card's attainable FP32
FMA rate, the roofline's denominator.

`fma_peak` is the kernel's wrapper: a CUDA tensor launches the kernel (or
raises), a CPU tensor takes `fma_peak_plain`, the same function in plain
PyTorch. `launches` counts kernel launches; `last_geometry` holds the chains a
thread, the block and the grid of the latest launch.

One rounding a step. The kernel's `fmaf` rounds `y * a + b` once. The plain
version computes the step in float64 and rounds the result to float32: the
product of two float32 values is exact in float64, so this is one rounding
too, apart from a rare double rounding of the sum (at most one float32 ulp on
that step). With the probe's constants (a = 1 + 8 ulp, b = 0.84 ulp at 1.0)
and inputs of 1.0, both add exactly 9 ulp a step for the first 58,000 steps
(exact arithmetic would add 8.84, so the value leaves `closed_form` by 3.7e-5
at 2,048 steps and by 0.7 % at the probe's high depth), so a comparison at
64 x 32 steps is exact; the tests and `chip_smoke.py` allow rtol 1e-5 for
other inputs.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from raptor_tpu_torch.ops import build

A = 1.000001  # keeps y finite over any depth
B = 1e-7
NFMA_BUILT = (1, 2, 4, 8, 16, 32, 64)  # csrc/fma_chain.cuh
CHAINS_PER_THREAD = 8  # csrc/fma_peak.cu
MAX_ELEMENTS = 2**31 - 2**20  # the kernel indexes with 32 bits

launches = 0
last_geometry: Optional[dict] = None


def default_elements(device) -> int:
    """The element count that fills the card: every SM's full count of
    resident threads, `CHAINS_PER_THREAD` elements each."""
    props = torch.cuda.get_device_properties(device)
    return props.multi_processor_count * props.max_threads_per_multi_processor * CHAINS_PER_THREAD


def closed_form(n_steps: int, a: float = A, b: float = B, y0: float = 1.0) -> float:
    """y after n_steps of y = y a + b in exact arithmetic, for the float32
    values of `a` and `b`: a^n (y0 + b / (a - 1)) - b / (a - 1)."""
    a32 = float(torch.tensor(a, dtype=torch.float32))
    b32 = float(torch.tensor(b, dtype=torch.float32))
    c = b32 / (a32 - 1.0)
    return a32**n_steps * (y0 + c) - c


def fma_peak_plain(
    x: torch.Tensor, depth: int, nfma: int = 32, a: float = A, b: float = B
) -> torch.Tensor:
    """The probe in plain PyTorch: a Python loop of depth x nfma steps, each
    computed in float64 from float32 operands and rounded to float32 (one
    rounding a step, as `fmaf`). For small depths."""
    a64 = torch.tensor(a, dtype=torch.float32, device=x.device).double()
    b64 = torch.tensor(b, dtype=torch.float32, device=x.device).double()
    y = x
    for _ in range(depth * nfma):
        y = (y.double() * a64 + b64).float()
    return y


def fma_peak_host(
    x: torch.Tensor, depth: int, nfma: int = 32, a: float = A, b: float = B
) -> torch.Tensor:
    """The kernel's per-element function (`csrc/fma_chain.cuh`) built with g++
    and looped over a CPU tensor."""
    _check(x, torch.device("cpu"), nfma)
    out = torch.empty_like(x)
    rc = build.host_library().raptor_fma_peak_host(
        x.data_ptr(), out.data_ptr(), x.numel(), int(depth), int(nfma), a, b)
    if rc != 0:
        raise RuntimeError(f"raptor_fma_peak_host failed: {rc}")
    return out


def _check(x: torch.Tensor, device: torch.device, nfma: int) -> None:
    if x.device != device:
        raise ValueError(f"x is on {x.device}, expected {device}")
    if x.dtype != torch.float32:
        raise ValueError(f"x must be float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if nfma not in NFMA_BUILT:
        raise ValueError(f"nfma must be one of {NFMA_BUILT}, got {nfma}")
    if x.numel() >= MAX_ELEMENTS:
        raise ValueError(f"at most {MAX_ELEMENTS - 1} elements, got {x.numel()}")


def fma_peak(
    x: torch.Tensor, depth: int, nfma: int = 32, a: float = A, b: float = B
) -> torch.Tensor:
    """The kernel's wrapper: x (f32, any shape, contiguous) -> the same shape
    after depth x nfma chained FMAs on every element. Does not synchronize."""
    global launches, last_geometry
    device = x.device
    _check(x, device, nfma)
    if device.type == "cpu":
        return fma_peak_plain(x, depth, nfma, a, b)
    if device.type != "cuda":
        raise ValueError(f"no FMA peak kernel for device {device}")
    lib = build.cuda_library()
    out = torch.empty_like(x)
    geometry = (ctypes.c_int * 3)()
    with torch.cuda.device(device):
        rc = lib.raptor_fma_peak(
            x.data_ptr(), out.data_ptr(), x.numel(), int(depth), int(nfma), a, b,
            ctypes.cast(geometry, ctypes.c_void_p),
            torch.cuda.current_stream(device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"raptor_fma_peak launch failed: CUDA error {rc}")
    launches += 1
    last_geometry = {
        "elements": x.numel(), "chains_per_thread": geometry[0], "block": geometry[1],
        "grid": geometry[2],
    }
    return out
