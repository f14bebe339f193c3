"""A run's `correct` against faults under the timed path, and the
control: on the CPU at tiny sizes (conftest.py's tiny traffic) with each
cell's own limits, the harness's look for a card skipped and the rest of
a run driven as on the card. A sound run comes out correct; a run with
each fault the cell can have (its kind's FAULTS) comes out not correct,
and so do the control's numbers (the plain reference in float8 in the
program's place)."""

import pytest

from benchmark import run

SPEC = run.load_spec()
CELLS = [w["name"] for w in SPEC["workloads"]]
SEED = 2 ** 31 + 77


def faults_of(cell, data):
    return sorted(run.load_kind(run.Cell(SPEC, cell, run.ROOT,
                                         data)).FAULTS)


def cases():
    from benchmark.conftest import BENCH
    return [(cell, fault) for cell in CELLS
            for fault in [None] + faults_of(cell, BENCH)]


@pytest.mark.parametrize("cell,fault", cases())
def test_correct_under_faults(cell, fault, tiny_data):
    hook = None
    if fault is not None:
        hook = run.load_kind(run.Cell(SPEC, cell, run.ROOT,
                                      tiny_data)).FAULTS[fault]
    res = run.run_cell(SPEC, cell, SEED, 0.5, False, device="cpu",
                       data=tiny_data, program_hook=hook)
    assert res["correct"] is (fault is None), res["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell, tiny_data):
    import torch

    c = run.Cell(SPEC, cell, run.ROOT, tiny_data)
    numbers = run.load_kind(c).control(c, SEED, torch.device("cpu"))
    ok, checks = run.judge(numbers, c.limits)
    assert not ok, checks
