"""Device run: the host's time in the loop of a run's replays (the program's
span `frenetix.device_sim.replay`: the graph launches), per cycle, in ms,
over the traced requests run again with the program's tracing on
(`portbench/program_trace.py`)."""

from portbench import program_trace


def read(run):
    got = program_trace.of(run)
    cycles = getattr(run.entry, "cycles", 0)
    if got is None or not cycles:
        return None
    per_request = program_trace.span_ms(got.slice, ("frenetix.device_sim.replay",))
    return None if per_request is None else per_request / cycles
