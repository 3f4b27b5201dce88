"""On a card, at each cell's own size: the program's readings pass the
cell's limits and the TF32 control's fail them. Skips without a card:

    python -m pytest -m cuda benchmark/tests/test_bench_card.py
"""

import pytest

import tinycell

import control
import core


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["distill_train", "eval_population", "eval_checkpoints",
                                      "farm_wave"])
def test_control_fails_at_the_cell_size(card, workload):
    cell = tinycell.cell(workload)
    if cell.traffic["kind"] == "eval":
        cell.traffic = dict(cell.traffic, check_range=cell.traffic["check_requests"] * 2)
    reading = control.readings(cell, 2**31 + 99, 2.0, card)
    assert core.judge(reading["program"], cell.limits)[0] is True, reading
    assert core.judge(reading["tf32"], cell.limits)[0] is False, reading
