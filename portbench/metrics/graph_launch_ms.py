"""Compiled programs: the host's time in the graphs' replays (the launch and
the counters' record), the program's span `frenetix.compiled.replay`, in ms
per request, over the traced requests run again with the program's tracing
on (`portbench/program_trace.py`)."""

from portbench import program_trace


def read(run):
    got = program_trace.of(run)
    if got is None:
        return None
    return program_trace.span_ms(got.slice, ("frenetix.compiled.replay",))
