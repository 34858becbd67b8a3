"""``correct`` at a size the CPU holds: true for the program, false for
the control in the program's place and for each planted fault that the
cell can have."""

import pytest

from portbench import faults, harness
from tinycells import tiny_cell


def _run(seed=21):
    return harness.run_cell(tiny_cell(), seed, 2.0, False, device="cpu")


def test_program_is_correct_and_control_is_not():
    out = _run()
    assert out["result"]["correct"], out["result"]["checks"]
    cell = tiny_cell()
    ctrl = harness.judge_window(cell, out["window"], out["traffic"], 21,
                                control=True)
    assert not ctrl.correct
    assert ctrl.values["objective_gap"] > cell.limits["objective_gap"]


@pytest.mark.parametrize("fault", faults.FAULTS)
def test_a_fault_is_not_correct(fault):
    with faults.plant(fault):
        out = _run()
    assert not out["result"]["correct"], out["result"]["checks"]
