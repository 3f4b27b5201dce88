"""The frozen copies in the benchmark's folder keep their numbers: the
per-env-step counts (a copy of the port's hand counts), the distillation and
SAC counts from shapes, the BPTT kernels' roofline, the published peaks and
the card reader."""

from types import SimpleNamespace

import pytest
import torch

import tinycell

import card
import core
import opcount
import peaks
from tracing import DeviceTrace


def test_env_step_counts_are_the_port_hand_counts():
    assert opcount.FLOPS_RK4_STEP == 1_082
    assert opcount.FLOPS_ROLLOUT_STEP == 1_102
    assert opcount.FLOPS_EVAL_STEP == 5_372
    assert opcount.FLOPS_ENV_STEP == 2_124
    from raptor_tpu_torch.apps import roofline

    counts = roofline.flop_counts()
    assert counts["eval_kernel_step_flops"] == opcount.FLOPS_EVAL_STEP
    assert counts["rollout_kernel_step_flops"] == opcount.FLOPS_ROLLOUT_STEP
    assert counts["env_step_flops"] == opcount.FLOPS_ENV_STEP


def test_distillation_step_from_shapes():
    assert opcount.student_forward_flops() == 4_304
    assert opcount.n_student_weights() == 2_084
    flops = opcount.distill_step_flops(64, 500)
    assert flops == 3 * 64 * 500 * 4_304 + 12 * 2_084
    assert flops == pytest.approx(0.413e9, rel=1e-3)


def test_bptt_counts_by_hand():
    """B = 64, T = 500, H = 16: a sample-step's forward is the reset select
    16, Dense 22->16 720 and its ReLU 16, the GRU's two gate matmuls 1,584
    each and its gates 240, the head 132 and the squared error 12; the
    backward twice that. Bytes: the float32 minibatch of 22 + 4 + 1 values a
    sample-step, the 2,084 weights read and their gradient written, the
    loss."""
    per_sample_step = 16 + 720 + 16 + 1_584 + 1_584 + 240 + 132 + 12
    assert per_sample_step == opcount.student_forward_flops() == 4_304
    assert opcount.bptt_flops(64, 500) == 3 * 64 * 500 * per_sample_step == 413_184_000
    assert opcount.bptt_bytes(64, 500) == 4 * (64 * 500 * 27 + 2 * 2_084 + 1) == 3_472_676
    seconds, bound = peaks.roofline_seconds(opcount.bptt_flops(64, 500),
                                            opcount.bptt_bytes(64, 500))
    assert bound == "ops" and seconds == pytest.approx(6.167e-6, rel=1e-3)
    assert opcount.distill_step_flops(64, 500) == 413_184_000 + 12 * 2_084


def test_b5_roofline_reads_the_bptt_kernels_of_the_traced_steps():
    """Three traced steps whose BPTT kernels take 0.75 ms a step read about
    0.82 %; other kernels do not count, and a trace without them reads
    nothing."""
    step = [("bptt_forward<16>", 330_000), ("bptt_backward<16>", 410_000),
            ("bptt_reduce<float>", 10_000), ("multi_tensor_apply_kernel", 9_000)]
    tr = DeviceTrace(torch.device("cpu"))
    tr.kernels = [(name, 0, ns) for _ in range(3) for name, ns in step]
    ctx = SimpleNamespace(cell=tinycell.cell("distill_train"), stats={}, device_trace=tr)
    reader = core.load_module("metrics", "b5_roofline")
    assert reader.read(ctx) == pytest.approx(100 * 3 * 6.1669e-6 / 2.25e-3, rel=1e-3)
    assert 0.8 < reader.read(ctx) < 0.85
    tr.kernels = [("eval_kernel", 0, 1000)]
    assert reader.read(ctx) is None


def test_eval_kernel_bytes_and_bound():
    assert opcount.eval_kernel_bytes(16_384, 2_084) == 4.0 * (2_084 + 16_384 * 79)
    seconds, bound = peaks.roofline_seconds(opcount.eval_kernel_flops(8_143_540), 5.2e6)
    assert bound == "ops" and seconds == pytest.approx(0.6529e-3, rel=1e-3)
    assert peaks.roofline_seconds(1.0, 1e9)[1] == "bytes"


def test_sac_counts_from_shapes():
    assert opcount.mlp_flops([41, 64, 64, 8]) == 2 * (41 * 64 + 64 * 64 + 64 * 8) + 136 + 128
    per_teacher = opcount.farm_super_step_flops(1, 32, 16, 16, 256, 31)
    assert per_teacher == opcount.farm_super_step_flops(128, 32, 16, 16, 256, 31) / 128
    assert 3e8 < per_teacher < 2e9


def test_published_peaks_and_card_reader():
    assert peaks.FP32_FLOPS == 67e12 and peaks.HBM_BYTES_PER_S == 3.35e12
    assert card.power_limit_watts("NVIDIA H100 80GB HBM3, 700.00 W") == 700.0
    assert card.power_limit_watts("nvidia-smi failed") is None
