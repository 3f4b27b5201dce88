"""Float32 matrix products for the references, and their TF32 control.

`matmul(a, b, "float32")` is a plain float32 product (the harness turns
TF32 off before any reference runs). `matmul(a, b, "tf32")` rounds both
operands to TF32, 10 explicit mantissa bits with round-to-nearest-even, as a
tensor core does with TF32 switched on, and accumulates in float32; its
gradient rounds the operands of the two backward products the same way.
"""

from __future__ import annotations

import torch


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to the nearest TF32 value (ties to even), kept as float32."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    rounded = (bits + 0x0FFF + lsb) & ~0x1FFF
    finite = torch.isfinite(x)
    return torch.where(finite, rounded.view(torch.float32), x)


class _TF32MatMul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        a, b = round_tf32(a), round_tf32(b)
        ctx.save_for_backward(a, b)
        return a @ b

    @staticmethod
    def backward(ctx, grad):
        a, b = ctx.saved_tensors
        g = round_tf32(grad)
        return g @ b.transpose(-1, -2), a.transpose(-1, -2) @ g


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str = "float32") -> torch.Tensor:
    if precision == "float32":
        return a @ b
    if precision == "tf32":
        return _TF32MatMul.apply(a, b)
    raise ValueError(f"unknown precision {precision!r}")
