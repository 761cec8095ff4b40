"""Compiled programs: CUDA graphs captured inside the window
(`utils.compiled.CAPTURES` at its end minus at its start)."""


def read(run):
    return float(run.captures)
