"""Cycle layer: device busy time (the union of every device interval) per
request over the traced slice, in ms."""


def read(run):
    if run.slice is None or run.slice.requests == 0 or run.slice.busy_s <= 0.0:
        return None
    return run.slice.busy_s * 1e3 / run.slice.requests
