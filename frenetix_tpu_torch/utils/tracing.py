"""Spans and counters inside the port, on the profiler's clock.

Tracing is off by default; `enable()` / `disable()` switch it, and
`with on():` turns it on for a block.  A CUDA graph captured under the
other state is never replayed (`utils.compiled._Graph.stale`): a compiled
entry and the device-resident run capture again at their next call, so no
graph keeps the event or counter nodes of the other state.

- `span(name)`: with tracing on, `torch.profiler.record_function(name)`,
  so a program span lands in the profiler's event stream beside CUPTI's
  device events; off, or inside a stream capture (host code does not run
  at replay), one shared no-op context.
- `device_span(name)`: inside a capture made by `utils.compiled`, a pair of
  timing events recorded around the block as event-record nodes of the
  graph.  Every replay records them again; before the entry replays again
  (and in `snapshot()`) the previous replay's elapsed time is added to the
  span's total, which waits for that replay's end where it has not
  finished.  Elsewhere it is a plain `span`: eager device work is timed by
  the profiler's device trace.
- `stream_span(name, device)`: with tracing on, the device time of the
  work the block enqueues on the device's current stream, from a pair of
  timing events recorded around it; the host does not wait for them, they
  are read in `snapshot()`.  Off the card, a plain `span`.
- `count(name, n)`: adds to a host counter, always on.  A captured graph
  records what its capture counted and adds it at each replay, so a
  replayed path counts what its eager twin counts.
- `device_count(name, t)`: with tracing on, adds the device tensor `t` to a
  persistent int64 accumulator on `t`'s device, capturable.  The
  accumulator is made on a captured graph's eager warm-up pass (which adds
  nothing) and never inside a capture.  Inside a capture that is not a
  compiled entry's (`capture()`), device spans and device counters do
  nothing.
- `snapshot()` syncs once and returns the spans' (total ms, count), the
  host counters and the device counters; `reset()` clears them.

Spans: `frenetix.compiled` (with `.key`, `.copy_in`, `.replay`, `.own`),
`frenetix.sampling.matrix` and `.pad`, `frenetix.device_sim.load`,
`.fleet.load`, `.reset`, `.capture`, `.replay`, `.fetch` and `.finalize`;
device spans `frenetix.risk.quadrature` and `frenetix.device_sim.cycles`.
Counters: `risk.quadrature.cells` (host) and `risk.quadrature.useful`
(device), `device_sim.cycles`, `.captures`, `.fetches`, `.programs`,
`.fleet.members`, `.fleet.agent_cycles_real` and
`.fleet.agent_cycles_stacked` (host), and
the kernels' launches `kernel.k1.launches`, `kernel.k2.launches` (K2a + K2b
pairs), `kernel.k3.launches` and `kernel.q.launches` (host; calls of the
plain twins are not counted).
"""
from __future__ import annotations

import collections
import contextlib
import threading

import torch

__all__ = ["COUNTERS", "enable", "disable", "enabled", "on", "span", "device_span",
           "stream_span", "count", "device_count", "snapshot", "reset"]

# host counters, name → count (always on)
COUNTERS: dict = {}

_ENABLED = False
_NOOP = contextlib.nullcontext()
# device span name → [total ms, replays folded]
_SPANS: dict = {}
# (name, device) → the counter's int64 accumulator
_DEVICE: dict = {}
# DeviceSpans whose last replay has not been folded yet
_PENDING: set = set()
# .capture: the device spans a compiled capture records; .warming: inside a
# captured graph's warm-up pass
_LOCAL = threading.local()


def enabled() -> bool:
    return _ENABLED


def enable() -> None:
    """Turn tracing on."""
    global _ENABLED
    _ENABLED = True


def disable() -> None:
    """Turn tracing off."""
    global _ENABLED
    _ENABLED = False


@contextlib.contextmanager
def on():
    """Tracing on inside the block, and back as it was after it."""
    global _ENABLED
    was, _ENABLED = _ENABLED, True
    try:
        yield
    finally:
        _ENABLED = was


def _capturing() -> bool:
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


def span(name: str):
    """A profiler span named `name` (see the module's doc)."""
    if not _ENABLED or _capturing():
        return _NOOP
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def _recorded(name: str, spans: list):
    start = torch.cuda.Event(enable_timing=True, external=True)
    end = torch.cuda.Event(enable_timing=True, external=True)
    start.record()
    yield
    end.record()
    spans.append((name, start, end))


def device_span(name: str):
    """Device time of the block at each replay of a compiled capture, else
    a plain `span` (see the module's doc)."""
    if not _ENABLED:
        return _NOOP
    spans = getattr(_LOCAL, "capture", None)
    if spans is not None and _capturing():
        return _recorded(name, spans)
    return span(name)


@contextlib.contextmanager
def _on_stream(name: str):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    yield
    end.record()
    DeviceSpans([(name, start, end)]).replayed()


def stream_span(name: str, device) -> object:
    """Device time of the work the block enqueues on `device`'s current
    stream, with tracing on (see the module's doc)."""
    if not _ENABLED:
        return _NOOP
    if torch.device(device).type != "cuda" or _capturing():
        return span(name)
    return _on_stream(name)


def count(name: str, n: int) -> None:
    COUNTERS[name] = COUNTERS.get(name, 0) + n


def device_count(name: str, t: torch.Tensor) -> None:
    """Add the device tensor `t` to the device counter `name`, with tracing
    on (see the module's doc)."""
    if not _ENABLED:
        return
    capturing = t.is_cuda and _capturing()
    if capturing and getattr(_LOCAL, "capture", None) is None:
        return
    key = (name, t.device)
    acc = _DEVICE.get(key)
    if acc is None:
        if capturing:
            raise RuntimeError(f"device counter {name!r} first used inside a capture; "
                               "its accumulator is made on the eager warm-up pass")
        acc = _DEVICE[key] = torch.zeros((), dtype=torch.int64, device=t.device)
    if not getattr(_LOCAL, "warming", False):
        acc.add_(t)


class DeviceSpans:
    """The device spans one compiled capture recorded: (name, start event,
    end event), which every replay of its graph records again."""

    __slots__ = ("spans", "pending")

    def __init__(self, spans):
        self.spans = tuple(spans)
        self.pending = False

    def fold(self) -> None:
        """Add the last replay's times to the spans' totals."""
        if not self.pending:
            return
        self.pending = False
        _PENDING.discard(self)
        for name, start, end in self.spans:
            end.synchronize()
            total = _SPANS.setdefault(name, [0.0, 0])
            total[0] += start.elapsed_time(end)
            total[1] += 1

    def replayed(self) -> None:
        self.pending = True
        _PENDING.add(self)


@contextlib.contextmanager
def warming():
    """A captured graph's eager warm-up pass (`utils.compiled._Graph`):
    device counters make their accumulators and add nothing."""
    saved = getattr(_LOCAL, "warming", False)
    _LOCAL.warming = True
    try:
        yield
    finally:
        _LOCAL.warming = saved


@contextlib.contextmanager
def capture():
    """A compiled entry's capture: yields the list its device spans are
    recorded into."""
    saved = getattr(_LOCAL, "capture", None)
    _LOCAL.capture = []
    try:
        yield _LOCAL.capture
    finally:
        _LOCAL.capture = saved


def snapshot() -> dict:
    """{"spans": {name: (total ms, count)}, "counters": {name: n},
    "device_counters": {name: n}}, the device's values read in one copy per
    device."""
    for pending in list(_PENDING):
        pending.fold()
    by_device = collections.defaultdict(list)
    for (name, device), acc in _DEVICE.items():
        by_device[device].append((name, acc))
    device_counters: dict = {}
    for items in by_device.values():
        values = torch.stack([acc for _, acc in items]).tolist()
        for (name, _), v in zip(items, values):
            device_counters[name] = device_counters.get(name, 0) + int(v)
    return {"spans": {k: (v[0], v[1]) for k, v in _SPANS.items()},
            "counters": dict(COUNTERS), "device_counters": device_counters}


def reset() -> None:
    """Clear every span total and counter; a replay not yet folded is
    dropped."""
    for pending in _PENDING:
        pending.pending = False
    _PENDING.clear()
    _SPANS.clear()
    COUNTERS.clear()
    for acc in _DEVICE.values():
        acc.zero_()
