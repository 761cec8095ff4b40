"""On the card, at the cell's own size: a short run of the device-resident
convoy (`convoy8.device_run`) comes out correct, and the control (the
reference's own run in bfloat16 in the program's place) does not.  Run there
with `python3 -m pytest portbench/tests/test_pb_card_device_run.py -m cuda -q`
(beside `test_pb_card.py`, which holds the other cells)."""
from __future__ import annotations

import pytest
import torch

from portbench import calibrate, judge, spec

CELL = "convoy8.device_run"


@pytest.mark.cuda
def test_program_correct_control_not():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    card = torch.device("cuda", 0)
    bench = spec.load()
    lims = judge.limits(spec.cell(bench, CELL)["config"])
    numbers, requests = calibrate.program_readings(CELL, 5_000_000_001, 3.0, card, bench)
    assert requests > 0 and judge.verdict(numbers, lims), numbers
    control = calibrate.control_readings(CELL, 5_000_000_002, card, bench)
    assert not judge.verdict(control, lims), control
