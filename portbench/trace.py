"""What the traced run reads from `torch.profiler`: device activity, host
spans, and the arithmetic of busy and idle time over a slice of requests.

The method is `frenetix_tpu_torch/profile_cycle.py`'s (commit eab69ff):
profile a bounded run of calls with CPU and CUDA activities and read the
device events by name.  Where `profile_cycle` adds kernel times, `busy`
here is the union of every device interval (kernels and copies), so
overlapping work counts once; idle is the rest of the slice's wall time.
Only summaries are kept, never a whole trace.
"""
from __future__ import annotations

import collections
from dataclasses import dataclass, field

SPAN_PREFIX = "portbench."
REQUEST_SPAN = SPAN_PREFIX + "request"
NAME_CHARS = 120


def union_length(intervals, lo, hi) -> float:
    """Total length of the union of (start, end) intervals clipped to
    [lo, hi]."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals, lo, hi):
    """The (start, end) stretches of [lo, hi] that no interval covers."""
    out, at = [], lo
    for s, e in sorted(intervals):
        if s > at:
            out.append((at, min(s, hi)))
        at = max(at, e)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(s, e) for s, e in out if e > s]


@dataclass
class Slice:
    """A traced slice: device intervals and host intervals (µs, one clock),
    each (start, end, name), and how many requests it spans."""

    device: list
    host: list
    requests: int
    start: float = 0.0
    end: float = 0.0
    by_name: dict = field(default_factory=dict)

    def __post_init__(self):
        spans = [(s, e) for s, e, n in self.host if n == REQUEST_SPAN]
        if spans:
            self.start = min(s for s, _ in spans)
            self.end = max(e for _, e in spans)
        by_name = collections.defaultdict(list)
        for s, e, n in self.device:
            if e > self.start and s < self.end:
                by_name[n].append(e - s)
        self.by_name = dict(by_name)

    @property
    def wall_s(self) -> float:
        return (self.end - self.start) * 1e-6

    @property
    def busy_s(self) -> float:
        return union_length([(s, e) for s, e, _ in self.device], self.start,
                            self.end) * 1e-6

    def kernel_mean_s(self, part: str):
        """Mean duration of the device operations whose name holds `part`,
        or None where there is none."""
        times = [t for n, ts in self.by_name.items() if part in n for t in ts]
        return sum(times) / len(times) * 1e-6 if times else None

    def top_ops(self, k=10):
        totals = sorted(((n, sum(ts) * 1e-6) for n, ts in self.by_name.items()),
                        key=lambda x: -x[1])
        return [[n[:NAME_CHARS], t] for n, t in totals[:k]]

    def idle_by_host(self, k=10):
        """Idle device time summed by what the host was doing at each gap's
        middle: the outermost benchmark span and the innermost host
        operation there."""
        totals = collections.defaultdict(float)
        host = sorted(self.host)
        at, live = 0, []
        for s, e in gaps([(a, b) for a, b, _ in self.device], self.start, self.end):
            mid = 0.5 * (s + e)
            while at < len(host) and host[at][0] <= mid:
                live.append(host[at])
                at += 1
            live = [h for h in live if h[1] >= mid]
            outer = [n for _, _, n in live if n.startswith(SPAN_PREFIX)
                     and n != REQUEST_SPAN]
            inner = min(live, key=lambda x: x[1] - x[0])[2][:NAME_CHARS] if live \
                else "no host span"
            name = f"{outer[0] if outer else 'between requests'} / {inner}"
            totals[name] += (e - s) * 1e-6
        return [[n, t] for n, t in sorted(totals.items(), key=lambda x: -x[1])[:k]]


def from_profiler(prof, requests: int) -> Slice:
    """The slice of a finished `torch.profiler.profile`."""
    import torch

    device, host = [], []
    for ev in prof.events():
        item = (float(ev.time_range.start), float(ev.time_range.end), ev.name)
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            host.append(item)
        elif not ev.name.startswith(SPAN_PREFIX):
            # the profiler mirrors every host span on the device's timeline;
            # those mark time, they are no device work
            device.append(item)
    return Slice(device=device, host=host, requests=requests)
