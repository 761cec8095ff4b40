"""Device run: the host's work around a run's replays, per request, in ms:
the scenario's inputs into the shared buffers, the carry's reset, the one
fetch and the host's epilogue (the program's spans
`frenetix.device_sim.load`, `.reset`, `.fetch` and `.finalize`), over the
traced requests run again with the program's tracing on
(`portbench/program_trace.py`)."""

from portbench import program_trace

NAMES = ("frenetix.device_sim.load", "frenetix.device_sim.reset",
         "frenetix.device_sim.fetch", "frenetix.device_sim.finalize")


def read(run):
    got = program_trace.of(run)
    return None if got is None else program_trace.span_ms(got.slice, NAMES)
