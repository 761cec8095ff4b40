"""Device run: the host's time to copy a fleet's inputs into the lasting
runner's buffers, per request, in ms (the program's span
`frenetix.device_sim.fleet.load`), over the traced requests run again
with the program's tracing on (`portbench/program_trace.py`).  None where
the program has no such span."""

from portbench import program_trace


def read(run):
    got = program_trace.of(run)
    return None if got is None else program_trace.span_ms(
        got.slice, ("frenetix.device_sim.fleet.load",))
