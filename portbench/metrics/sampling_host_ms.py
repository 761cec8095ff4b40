"""Sampling (host): the host's sampling matrix, the program's spans
`frenetix.sampling.matrix` and `frenetix.sampling.pad`, in ms per request,
over the traced requests run again with the program's tracing on
(`portbench/program_trace.py`)."""

from portbench import program_trace

NAMES = ("frenetix.sampling.matrix", "frenetix.sampling.pad")


def read(run):
    got = program_trace.of(run)
    return None if got is None else program_trace.span_ms(got.slice, NAMES)
