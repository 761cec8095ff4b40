"""The metric arithmetic: a tail over every request, rates over all work
and the whole window, K1's bytes and bound, the profiler slice's busy and
idle time, and readers that find nothing to read."""
from __future__ import annotations

import types

import numpy as np
import pytest
import torch

from portbench import e2e, k1_bound, metrics, run, trace


def _window(lat_ms, seconds=10.0, candidates=100):
    w = run.Window(setup_s=3.0, candidates=candidates)
    w.latencies_s = [x * 1e-3 for x in lat_ms]
    w.seconds = seconds
    return w


def test_p95_is_over_all_requests():
    # 90 fast requests then 10 slow ones: a median of chunk p95s would hide them
    lat = [1.0] * 90 + [50.0] * 10
    assert e2e.cycle_ms_p95(_window(lat)) == pytest.approx(np.percentile(lat, 95))
    assert e2e.cycle_ms_p95(_window(lat)) == pytest.approx(50.0)


@pytest.mark.parametrize("name,base", [
    ("cycle_ms_p95", "cycle_ms_p95"), ("cycle_ms_p95.risk", "cycle_ms_p95"),
    ("cand_evals_per_s.risk", "cand_evals_per_s"), ("setup_s", "setup_s"),
])
def test_metric_found_by_its_name_up_to_the_first_dot(name, base):
    assert e2e.function(name) is e2e.METRICS[base]
    if "." in name:
        assert metrics.load("cycle_busy_ms" + name[name.index("."):]) \
            is metrics.load("cycle_busy_ms")


def test_rate_is_all_work_over_the_whole_window():
    w = _window([5.0] * 400, seconds=2.5, candidates=34_320)
    assert e2e.cand_evals_per_s(w) == pytest.approx(34_320 * 400 / 2.5)
    assert e2e.setup_s(w) == 3.0


@pytest.mark.parametrize("shape,bytes_,ms", [
    ((868, 7, 1_079_296), 38_878_960, 0.0116),     # the dense cycle (PERF.md)
    ((6_944, 7, 253_952), 9_336_704, 0.0028),      # the stacked cycle, A = 8
])
def test_k1_bytes_and_bound(shape, bytes_, ms):
    bound, by, n_bytes = k1_bound.k1_bound_ms(*shape)
    assert n_bytes == bytes_
    assert by == "bytes"
    assert bound == pytest.approx(ms, abs=5e-5)


def test_union_and_gaps():
    iv = [(0.0, 2.0), (1.0, 3.0), (5.0, 6.0), (10.0, 20.0)]
    assert trace.union_length(iv, 0.0, 12.0) == pytest.approx(6.0)
    assert trace.gaps(iv, 0.0, 12.0) == [(3.0, 5.0), (6.0, 10.0)]
    assert trace.gaps([], 1.0, 2.0) == [(1.0, 2.0)]


def _slice():
    host = [(0.0, 100.0, trace.REQUEST_SPAN), (100.0, 200.0, trace.REQUEST_SPAN),
            (0.0, 30.0, "portbench.matrix"), (0.0, 30.0, "np.concatenate"),
            (100.0, 130.0, "portbench.matrix")]
    device = [(30.0, 60.0, "table_interp_kernel<float>"), (60.0, 90.0, "add"),
              (130.0, 190.0, "add")]
    return trace.Slice(device=device, host=host, requests=2)


def test_slice_busy_idle_and_breakdown():
    sl = _slice()
    assert sl.wall_s == pytest.approx(200e-6)
    assert sl.busy_s == pytest.approx(120e-6)
    assert sl.kernel_mean_s("table_interp_kernel") == pytest.approx(30e-6)
    assert sl.kernel_mean_s("nothing") is None
    assert sl.top_ops()[0] == ["add", pytest.approx(90e-6)]
    idle = dict((n, t) for n, t in sl.idle_by_host())
    assert idle["portbench.matrix / np.concatenate"] == pytest.approx(30e-6)
    assert sum(idle.values()) == pytest.approx(80e-6)


def test_profiler_spans_are_no_device_work():
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    def ev(s, e, name, dev):
        return types.SimpleNamespace(time_range=types.SimpleNamespace(start=s, end=e),
                                     name=name, device_type=dev)

    prof = types.SimpleNamespace(events=lambda: [
        ev(0.0, 100.0, trace.REQUEST_SPAN, cpu), ev(0.0, 100.0, "portbench.program", cuda),
        ev(10.0, 20.0, "kernel", cuda)])
    sl = trace.from_profiler(prof, 1)
    assert sl.busy_s == pytest.approx(10e-6)


def test_readers():
    sl = _slice()
    shape = (868, 7, 1_079_296)
    ran = run.Run(entry=None, k1_shape=shape, captures=2, slice=sl)
    assert metrics.load("device_idle_share").read(ran) == pytest.approx(40.0)
    assert metrics.load("cycle_busy_ms").read(ran) == pytest.approx(0.06)
    bound = k1_bound.k1_bound_ms(*shape)[0]
    assert metrics.load("k1_roofline").read(ran) == pytest.approx(100 * bound / 0.03)
    assert metrics.load("graph_captures").read(ran) == 2.0
    empty = run.Run(entry=types.SimpleNamespace(risk_inputs=lambda p: None),
                    k1_shape=shape, captures=0, slice=None, traced=[object()])
    for name in ("device_idle_share", "cycle_busy_ms", "k1_roofline",
                 "risk_quadrature_ms"):
        assert metrics.load(name).read(empty) is None
