"""Device run: the share of a fleet's stacked agent-cycles that are real,
in %: 100 × Σ each member's agents × its cycles over the scenario axis ×
the buffers' agents × their cycles (the program's counters
`device_sim.fleet.agent_cycles_real` and `.agent_cycles_stacked`), over
the traced requests run again with the program's tracing on
(`portbench/program_trace.py`).  None where the program counts no fleet."""

from portbench import program_trace


def read(run):
    got = program_trace.of(run)
    if got is None:
        return None
    counters = got.snapshot["counters"]
    stacked = counters.get("device_sim.fleet.agent_cycles_stacked")
    if not stacked:
        return None
    return 100.0 * counters.get("device_sim.fleet.agent_cycles_real", 0) / stacked
