"""The readers of the program's spans and counters: on a synthetic slice
with nested program spans and on a stubbed snapshot, clipped to the slice,
None where their spans or counters are missing or the program has no
tracing module, and a CPU run of the dense cell that reads them when traced
and leaves the program's tracing off."""
from __future__ import annotations

import sys

import pytest
import torch

from frenetix_tpu_torch.utils import tracing

from portbench import metrics, program_trace, run, trace
from portbench.entries import dense_cycle
from portbench.tests.conftest import tiny

NEW = ("sampling_host_ms", "compiled_host_ms", "graph_launch_ms", "graph_launch_ms.risk",
       "quadrature_replay_ms", "quadrature_useful_share")


def _slice():
    """Two requests of 100 µs; in each, the matrix (20 + 5 µs of spans) and
    compiled calls with their replays.  A matrix span and a compiled call
    start before the slice and are clipped to it."""
    host = [(0.0, 100.0, trace.REQUEST_SPAN), (100.0, 200.0, trace.REQUEST_SPAN),
            (-10.0, 20.0, "frenetix.sampling.matrix"), (20.0, 25.0, "frenetix.sampling.pad"),
            (100.0, 120.0, "frenetix.sampling.matrix"), (120.0, 125.0, "frenetix.sampling.pad"),
            (5.0, 15.0, "np.concatenate")]
    for at in (-60.0, 100.0):               # the first starts 10 µs before the slice
        host += [(at + 50.0, at + 80.0, "frenetix.compiled"),
                 (at + 50.0, at + 55.0, "frenetix.compiled.key"),
                 (at + 55.0, at + 60.0, "frenetix.compiled.copy_in"),
                 (at + 60.0, at + 72.0, "frenetix.compiled.replay"),
                 (at + 72.0, at + 80.0, "frenetix.compiled.own")]
    host += [(85.0, 95.0, "frenetix.compiled"), (87.0, 91.0, "frenetix.compiled.replay"),
             (185.0, 195.0, "frenetix.compiled"), (187.0, 191.0, "frenetix.compiled.replay")]
    return trace.Slice(device=[(60.0, 80.0, "add")], host=host, requests=2)


def _run_with(sl=None, snapshot=None):
    ran = run.Run(entry=None, k1_shape=(1, 1, 1), captures=0)
    ran.program_trace = program_trace.ProgramTrace(
        slice=sl or trace.Slice(device=[], host=[], requests=0),
        snapshot=snapshot or {"spans": {}, "counters": {}, "device_counters": {}})
    return ran


def test_span_readers_on_a_synthetic_slice():
    ran = _run_with(_slice())
    # matrix: 20 (clipped from 30) + 5 + 20 + 5 µs over 2 requests
    assert metrics.load("sampling_host_ms").read(ran) == pytest.approx(0.025)
    # compiled less its replays: (20 clipped − 12) + (30 − 12) + 2 × (10 − 4) µs
    assert metrics.load("compiled_host_ms").read(ran) == pytest.approx(0.019)
    # replays: 12 + 12 + 4 + 4 µs
    assert metrics.load("graph_launch_ms").read(ran) == pytest.approx(0.016)
    assert metrics.load("graph_launch_ms.risk") is metrics.load("graph_launch_ms")


def test_span_readers_clip_to_the_slice():
    sl = trace.Slice(device=[], requests=1, host=[
        (0.0, 100.0, trace.REQUEST_SPAN),
        (-50.0, 10.0, "frenetix.sampling.matrix"), (95.0, 150.0, "frenetix.sampling.pad"),
        (300.0, 400.0, "frenetix.sampling.matrix")])
    assert metrics.load("sampling_host_ms").read(_run_with(sl)) == pytest.approx(0.015)


def test_counter_readers_on_a_stubbed_snapshot():
    ran = _run_with(snapshot={"spans": {"frenetix.risk.quadrature": (600.0, 3)},
                              "counters": {"risk.quadrature.cells": 8000},
                              "device_counters": {"risk.quadrature.useful": 200}})
    assert metrics.load("quadrature_replay_ms").read(ran) == pytest.approx(200.0)
    assert metrics.load("quadrature_useful_share").read(ran) == pytest.approx(2.5)
    none = _run_with(snapshot={"spans": {}, "counters": {"risk.quadrature.cells": 10},
                               "device_counters": {"risk.quadrature.useful": 0}})
    assert metrics.load("quadrature_useful_share").read(none) == 0.0


@pytest.mark.parametrize("name", NEW)
def test_readers_return_none_where_nothing_is_there(name, monkeypatch):
    reader = metrics.load(name)
    assert reader.read(_run_with()) is None
    bare = run.Run(entry=None, k1_shape=(1, 1, 1), captures=0, traced=[])
    assert reader.read(bare) is None
    # a program without `utils.tracing` (the parent of this reader)
    monkeypatch.delattr(sys.modules["frenetix_tpu_torch.utils"], "tracing")
    monkeypatch.setitem(sys.modules, "frenetix_tpu_torch.utils.tracing", None)
    older = run.Run(entry=None, k1_shape=(1, 1, 1), captures=0, traced=[object()])
    assert reader.read(older) is None


def test_a_cpu_run_reads_the_program_spans_and_leaves_tracing_off(cpu, monkeypatch):
    seen = []
    request = dense_cycle.Entry.request

    def recorded(self, prepared):
        seen.append(tracing.enabled())
        return request(self, prepared)

    monkeypatch.setattr(dense_cycle.Entry, "request", recorded)
    config, mix = tiny("ego_dense.sweep")
    for traced in (False, True):
        seen.clear()
        result, checks, window = run.run_cell("ego_dense.sweep", 2 ** 31 + 5, 0.2, traced,
                                              cpu, config=config, mix=mix,
                                              setup_from=lambda: 0.0)
        assert result["correct"], checks
        assert not tracing.enabled()
        n = config["warmup_requests"] + len(window.latencies_s)
        assert not any(seen[:n])                   # the window runs with tracing off
        if traced:
            assert result["metrics"]["sampling_host_ms"]["value"] > 0.0
            assert result["metrics"]["compiled_host_ms"]["value"] > 0.0
            assert all(seen[n:]) and len(seen) > n  # the readers' run, tracing on
        else:
            assert len(seen) == n and not set(NEW) & set(result["metrics"])
    torch.set_num_threads(4)
