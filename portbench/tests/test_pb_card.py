"""On the card, at each cell's own size: a short run of the program comes
out correct, and the control (the reference in bfloat16 in the program's
place) does not.  Run there with
`python3 -m pytest portbench/tests/test_pb_card.py -m cuda -q`."""
from __future__ import annotations

import pytest
import torch

from portbench import calibrate, judge, spec

CELLS = ("ego_dense.sweep", "convoy8_risk.near", "convoy8_risk.open", "convoy8.plain")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_program_correct_control_not(workload, card):
    bench = spec.load()
    lims = judge.limits(spec.cell(bench, workload)["config"])
    numbers, requests = calibrate.program_readings(workload, 5_000_000_001, 1.0, card,
                                                   bench)
    assert requests > 0 and judge.verdict(numbers, lims), numbers
    control = calibrate.control_readings(workload, 5_000_000_002, card, bench)
    assert not judge.verdict(control, lims), control
