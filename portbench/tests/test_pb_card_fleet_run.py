"""On the card, at the cell's own size: a short traced run of the fleet
(`fleet32.device`, 32 members a request) comes out correct, one capture
serves both fleets of the pool (`run_captures.fleet` reads 0 after the
warm-up) and 35.0 % of the stacked agent-cycles are real
(`fleet_row_fill`); the control (the reference's own runs in bfloat16 in
the program's place) does not come out correct.  Run there with
`python3 -m pytest portbench/tests/test_pb_card_fleet_run.py -m cuda -q`."""
from __future__ import annotations

import pytest
import torch

from portbench import calibrate, judge, run, spec

CELL = "fleet32.device"
REAL, STACKED = 12_736, 32 * 8 * 142       # agent-cycles of a fleet of 32


@pytest.mark.cuda
def test_program_correct_one_capture_control_not():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    card = torch.device("cuda", 0)
    bench = spec.load()
    lims = judge.limits(spec.cell(bench, CELL)["config"])
    result, checks, _ = run.run_cell(CELL, 5_000_000_011, 3.0, True, card, bench=bench,
                                     setup_from=lambda: 0.0)
    assert result["attempted"] > 0 and result["correct"], checks
    got = result["metrics"]
    assert got["run_captures.fleet"]["value"] == 0.0
    assert got["fleet_row_fill"]["value"] == pytest.approx(100.0 * REAL / STACKED)
    control = calibrate.control_readings(CELL, 5_000_000_012, card, bench)
    assert not judge.verdict(control, lims), control
