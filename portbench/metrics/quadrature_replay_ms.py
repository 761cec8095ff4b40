"""Risk stack: the collision-probability quadrature's device time inside the
replayed graph, the program's device span `frenetix.risk.quadrature`
(timing events recorded as graph nodes), its mean per replay in ms, over
the traced requests run again with the program's tracing on
(`portbench/program_trace.py`)."""

from portbench import program_trace

SPAN = "frenetix.risk.quadrature"


def read(run):
    got = program_trace.of(run)
    if got is None or SPAN not in got.snapshot["spans"]:
        return None
    total_ms, count = got.snapshot["spans"][SPAN]
    return total_ms / count if count else None
