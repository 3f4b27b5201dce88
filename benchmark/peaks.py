"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at the card's full 700 W). Every share the benchmark reports is against
these, with the card's power limit recorded beside it (`card.py`)."""

FP32_FLOPS = 67e12  # FP32 outside the tensor cores; the configurations state FP32 with TF32 off
HBM_BYTES_PER_S = 3.35e12  # 80 GB of HBM3


def roofline_seconds(flops: float, nbytes: float) -> tuple:
    """(least seconds the card could take, "ops" or "bytes": which bound)."""
    t_ops, t_bytes = flops / FP32_FLOPS, nbytes / HBM_BYTES_PER_S
    return (t_ops, "ops") if t_ops >= t_bytes else (t_bytes, "bytes")
