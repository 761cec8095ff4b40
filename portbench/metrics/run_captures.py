"""Device run: the run's graphs captured over the traced requests (the
program's counter `device_sim.captures`), after they were warmed up again
with the program's tracing on (`portbench/program_trace.py`): 0 where one
captured run serves every scenario.  None where no run counted its cycles
(`device_sim.cycles`)."""

from portbench import program_trace


def read(run):
    got = program_trace.of(run)
    if got is None or not got.snapshot["counters"].get("device_sim.cycles"):
        return None
    return float(got.snapshot["counters"].get("device_sim.captures", 0))
