"""Device run: the device time of a run's cycles, from the first replay's
start to the last one's end (the program's device span
`frenetix.device_sim.cycles`, two timing events on the stream), over the
cycles of a request, in ms.

Read outside the profiler, whose device tracing slows every kernel of the
run: after the window, with the program's tracing on, the entry is warmed
up again on the traced requests as before the window (`warmup_requests`
runs, the first of which captures the run anew; fewer leave the host's
launches slower than the card's cycle), then the traced requests run once
more and the span is read from `tracing.snapshot()`.  None where the
program has no tracing module or no such span."""
from __future__ import annotations

SPAN = "frenetix.device_sim.cycles"


def read(run):
    try:
        from frenetix_tpu_torch.utils import tracing
    except ImportError:
        return None
    cycles = getattr(run.entry, "cycles", 0)
    if not run.traced or not cycles:
        return None
    with tracing.on():
        for i in range(run.entry.config["warmup_requests"]):
            run.entry.request(run.traced[i % len(run.traced)])
        tracing.reset()
        for prepared in run.traced:
            run.entry.request(prepared)
        spans = tracing.snapshot()["spans"]
    if SPAN not in spans:
        return None
    total_ms, runs = spans[SPAN]
    return total_ms / runs / cycles if runs else None
