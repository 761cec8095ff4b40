"""The program's own spans and counters (`frenetix_tpu_torch.utils.tracing`)
over the traced slice's requests, for the readers of program spans and
counters.

The window runs with the program's tracing off.  After it, the first such
reader turns tracing on, which drops the compiled programs, so that they
are captured again with their device spans and counters as graph nodes.  It
then warms the entry up on the slice's requests and clears the counters.
Next it runs the slice's requests once more under `torch.profiler`, each in
the request span as the window does.  Last it reads the counters and turns
tracing off again.  The result is kept on the run for the other readers.
All of it comes after `graph_captures`, the peak memory and the end-to-end
numbers were taken.  Where the program has no tracing module, or the run
no traced requests, there is nothing to read (None).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from portbench import run as harness
from portbench import trace


@dataclass
class ProgramTrace:
    slice: trace.Slice      # the traced requests run again, the program's spans in it
    snapshot: dict          # `tracing.snapshot()` over those requests


def of(run):
    """The run's ProgramTrace, made at the first call, or None."""
    if not hasattr(run, "program_trace"):
        run.program_trace = _made(run)
    return run.program_trace


def _made(run):
    try:
        from frenetix_tpu_torch.utils import tracing
    except ImportError:
        return None
    if not run.traced:
        return None
    entry, device = run.entry, run.entry.device
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with tracing.on():
        for i in range(entry.config["warmup_requests"]):
            entry.request(run.traced[i % len(run.traced)])
        harness._sync(device)
        tracing.reset()
        with torch.profiler.profile(activities=activities) as prof:
            for prepared in run.traced:
                with torch.profiler.record_function(trace.REQUEST_SPAN):
                    entry.request(prepared)
            harness._sync(device)
        snapshot = tracing.snapshot()
    return ProgramTrace(trace.from_profiler(prof, len(run.traced)), snapshot)


def span_ms(sl, names, minus=()):
    """ms per request of the union of the host spans named in `names`,
    clipped to the slice, less the union of those named in `minus` (spans
    that lie inside the first); None where no span is named in `names`."""
    spans = [(s, e) for s, e, n in sl.host if n in names]
    if not spans or sl.requests == 0:
        return None
    total = trace.union_length(spans, sl.start, sl.end)
    inner = [(s, e) for s, e, n in sl.host if n in minus]
    total -= trace.union_length(inner, sl.start, sl.end)
    return total * 1e-3 / sl.requests
