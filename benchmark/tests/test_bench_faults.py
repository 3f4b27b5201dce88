"""A run with the timed path broken underneath reads `correct` false: each
fault a cell can have, planted in the port (`faults.py`), at a tiny size on
the CPU. The look for a card is skipped; the rest of a run is driven as it
is on the card. A sound run of the same size reads `correct` true."""

import pytest

import tinycell

import faults

CELLS = {"distill_train": "distill", "eval_population": "eval", "eval_checkpoints": "eval",
         "farm_wave": "farm"}


@pytest.mark.parametrize("workload", sorted(CELLS))
def test_sound_run_is_correct(workload):
    result = tinycell.run(workload)
    assert result["correct"] is True, result["checks"]
    assert result["failed"] == 0


@pytest.mark.parametrize("fault", sorted(faults.FAULTS["distill"]))
@pytest.mark.parametrize("workload", sorted(CELLS))
def test_fault_makes_the_run_incorrect(workload, fault):
    with faults.planted(CELLS[workload], fault):
        result = tinycell.run(workload)
    assert result["correct"] is False, (fault, result["checks"])
