"""Risk stack: the share of the quadrature's (agent, candidate, obstacle,
step) cells that lie inside the 5 m gate of a valid obstacle slot, the only
ones whose probability can be non-zero: 100 × the device counter
`risk.quadrature.useful` over the host counter `risk.quadrature.cells`, in
%, over the traced requests run again with the program's tracing on
(`portbench/program_trace.py`)."""

from portbench import program_trace


def read(run):
    got = program_trace.of(run)
    if got is None:
        return None
    cells = got.snapshot["counters"].get("risk.quadrature.cells", 0)
    useful = got.snapshot["device_counters"].get("risk.quadrature.useful")
    if not cells or useful is None:
        return None
    return 100.0 * useful / cells
