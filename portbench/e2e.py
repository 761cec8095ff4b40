"""End-to-end metric arithmetic, by name: each is taken over every request
the window completed and all of its time.  A metric's arithmetic is found
by its name up to the first dot, so `cycle_ms_p95.risk` is `cycle_ms_p95`
over the cells that report it under that name (a bound of its own)."""
from __future__ import annotations

import numpy as np


def cycle_ms_p95(window) -> float:
    """95th percentile over every request of its latency, host clock, in ms,
    over its planning cycles (a request of many cycles gives its mean
    cycle time; one of one cycle, its latency)."""
    return float(np.percentile(np.asarray(window.latencies_s) * 1e3 / window.cycles, 95))


def cand_evals_per_s(window) -> float:
    """Real (unpadded) candidates of all completed requests, over all their
    cycles, over the window's seconds."""
    return window.candidates * len(window.latencies_s) / window.seconds


def setup_s(window) -> float:
    return window.setup_s


METRICS = {f.__name__: f for f in (setup_s, cycle_ms_p95, cand_evals_per_s)}


def function(name: str):
    return METRICS[name.split(".")[0]]
