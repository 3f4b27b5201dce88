"""The frozen copies in the benchmark's folder keep their numbers: the
per-env-step counts (a copy of the port's hand counts), the distillation and
SAC counts from shapes, the published peaks and the card reader."""

import pytest

import tinycell  # noqa: F401  (puts the benchmark on the path)

import card
import opcount
import peaks


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
