"""Spans and counters inside the port (`utils.tracing`) on the CPU.

- (a) with tracing on, a compiled call under `torch.profiler` is the span
  `frenetix.compiled` with `.key`, `.copy_in`, `.replay` and `.own` inside
  it, and the host sampling matrix is `frenetix.sampling.matrix` and
  `.pad`; with tracing off the same profile holds no `frenetix.` event;
- (b) a counter bumped in a compiled body counts per call as its eager
  twin does, and a captured graph (`utils.compiled._Graph`) adds its record
  of host counters, the kernels' launches among them, at each replay;
- (c) on a small rollout with one obstacle slot near, one far and one
  invalid, `risk.quadrature.cells` and `risk.quadrature.useful` equal a
  plain NumPy count of the cells and of (gate ∧ valid), eager and compiled;
- (d) with tracing off `device_count` makes no accumulator and the
  quadrature's device counter stays unmade;
- (e) `snapshot()` and `reset()` round-trip, device spans folded once per
  replay included;
- a switch of tracing makes every compiled entry capture again at its next
  call, and `on()` restores the state it found;
- the layering, read from the sources with `ast`: `utils.tracing` imports
  nothing of the port, `utils.compiled` only `utils.tracing`, no other
  module captures a CUDA graph, and no module keeps a `LAUNCHES` global.

The card's case (a device span inside a CUDA graph, timed at each replay)
carries the `cuda` marker and skips here.
"""
from __future__ import annotations

import ast
import functools
from pathlib import Path
from typing import NamedTuple

import numpy as np
import pytest
import torch

from frenetix_tpu_torch.ops import sampling
from frenetix_tpu_torch.ops.costs import PredictionTensors
from frenetix_tpu_torch.ops.kinematics import VehicleParams
from frenetix_tpu_torch.risk.probability import collision_probability_fast
from frenetix_tpu_torch.utils import compiled as C
from frenetix_tpu_torch.utils import tracing


@pytest.fixture(autouse=True)
def _off_and_clear():
    tracing.disable()
    tracing.reset()
    C.clear_all()
    yield
    tracing.disable()
    tracing.reset()
    C.clear_all()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _program():
    @C.compiled(static=("scale",))
    def program(x, *, scale):
        tracing.count("test.elements", x.numel())
        return {"y": x * scale, "n": (x > 0).sum()}

    return program


def _profiled(fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return [(float(e.time_range.start), float(e.time_range.end), e.name)
            for e in prof.events()]


# ------------------------------------------------------------------ (a)


def test_compiled_call_is_a_span_with_its_four_children():
    program = _program()
    x = torch.arange(6.0)

    def calls():
        program(x, scale=2.0)
        program(x + 1.0, scale=2.0)
        sampling.pad_matrix(sampling.build_sampling_matrix(
            t1_vals=[1.0, 2.0], ss1_vals=[3.0], d1_vals=[0.0, 1.0],
            x0_lon=(0.0, 3.0, 0.0), x0_lat=(0.0, 0.0, 0.0)), 8)

    with tracing.on():
        events = _profiled(calls)
    outer = [(s, e) for s, e, n in events if n == "frenetix.compiled"]
    assert len(outer) == 2
    for child in ("key", "copy_in", "replay", "own"):
        inner = [(s, e) for s, e, n in events if n == f"frenetix.compiled.{child}"]
        assert len(inner) == 2, child
        for (s, e), (ps, pe) in zip(sorted(inner), sorted(outer)):
            assert ps <= s <= e <= pe, child
    names = {n for _, _, n in events}
    assert {"frenetix.sampling.matrix", "frenetix.sampling.pad"} <= names

    assert not [n for _, _, n in _profiled(calls) if n.startswith("frenetix.")]


def test_nested_compiled_calls_emit_no_span_of_their_own():
    inner = _program()

    @C.compiled
    def outer(x):
        return inner(x, scale=3.0)["y"] + 1.0

    with tracing.on():
        events = _profiled(lambda: outer(torch.ones(4)))
    assert [n for _, _, n in events].count("frenetix.compiled") == 1


# ------------------------------------------------------------------ (b)


def test_a_counter_in_a_compiled_body_counts_per_call_as_its_eager_twin():
    program = _program()
    xs = [torch.arange(6.0), torch.arange(6.0) - 2.0, torch.ones(6)]
    with C.disable_compiled():
        for x in xs:
            program(x, scale=2.0)
        eager = dict(tracing.COUNTERS)
    tracing.reset()
    for x in xs:
        program(x, scale=2.0)
    assert len(program.entries) == 1
    # the CPU runs the kernels' plain twins, which count no launch
    assert tracing.COUNTERS == eager == {"test.elements": 18}


class _Replays:
    """A stand-in for a CUDA graph: counts its replays."""

    def __init__(self):
        self.n = 0

    def replay(self):
        self.n += 1


def _captured(counts: dict, traced: bool) -> C._Graph:
    """A `_Graph` as a capture with tracing `traced` leaves it (the CPU
    captures nothing)."""
    graph = C._Graph.__new__(C._Graph)
    graph.graph, graph.out, graph.counts, graph.traced = _Replays(), None, counts, traced
    return graph


def test_a_capture_record_adds_every_host_counter_at_each_replay():
    record = {"kernel.k1.launches": 2, "kernel.k2.launches": 2, "kernel.q.launches": 1,
              "test.cells": 30}
    graph = _captured(dict(record), traced=False)
    for _ in range(3):
        graph.replay()
    assert graph.graph.n == 3
    assert tracing.COUNTERS == {name: 3 * n for name, n in record.items()}


# ------------------------------------------------------------------ (c)


class _Rollout(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    theta_gl: torch.Tensor


def _near_far_invalid(m=5, n1=9):
    """m candidates along the x axis; slot 0 drives 3 m beside them (near),
    slot 1 80 m ahead (far), slot 2 beside them but invalid."""
    t = torch.arange(n1, dtype=torch.float64)
    x = torch.stack([t * (1.0 + 0.5 * k) for k in range(m)])
    y = torch.zeros_like(x)
    ro = _Rollout(x=x, y=y, theta_gl=torch.zeros_like(x))
    o, horizon = 3, n1
    means = torch.zeros((o, horizon, 2), dtype=torch.float64)
    means[0, :, 0], means[0, :, 1] = t * 1.2, 3.0
    means[1, :, 0] = 80.0 + t
    means[2, :, 0], means[2, :, 1] = t, 1.0
    eye = torch.eye(2, dtype=torch.float64).expand(o, horizon, 2, 2) * 0.5
    valid = torch.ones((o, horizon), dtype=torch.bool)
    valid[2] = False
    valid[0, -3:] = False
    preds = PredictionTensors(
        means=means, inv_covs=eye * 4.0, covs=eye.clone(),
        orientations=torch.zeros((o, horizon), dtype=torch.float64),
        velocities=torch.ones((o, horizon), dtype=torch.float64),
        lengths=torch.full((o,), 4.0, dtype=torch.float64),
        widths=torch.full((o,), 2.0, dtype=torch.float64), valid=valid)
    return ro, preds


def _numpy_counts(ro, preds):
    """(cells, cells inside the 5 m gate of a valid slot), by loops."""
    n1, horizon = ro.x.shape[-1], preds.means.shape[-2]
    t = min(n1 - 1, horizon - 1)
    x, y = ro.x.numpy(), ro.y.numpy()
    means, yaw = preds.means.numpy(), preds.orientations.numpy()
    half = preds.lengths.numpy() / 2.0
    valid = preds.valid.numpy()
    useful = 0
    for c in range(x.shape[0]):
        for o in range(means.shape[0]):
            for j in range(t):
                ego = np.array([x[c, j + 1], y[c, j + 1]])
                axis = np.array([np.cos(yaw[o, j + 1]), np.sin(yaw[o, j + 1])]) * half[o]
                points = (means[o, j], means[o, j] + axis, means[o, j] - axis)
                gate = min(np.linalg.norm(p - ego) for p in points) <= 5.0
                useful += bool(gate and valid[o, j])
    return x.shape[0] * means.shape[0] * t, useful


@pytest.mark.parametrize("path", ["eager", "compiled"])
def test_quadrature_counters_equal_a_plain_count(path):
    ro, preds = _near_far_invalid()
    cells, useful = _numpy_counts(ro, preds)
    assert 0 < useful < cells
    veh = VehicleParams()
    call = collision_probability_fast
    if path == "compiled":
        call = C.compiled(collision_probability_fast)
    with tracing.on():
        for _ in range(2):
            call(ro, preds, veh)
        snap = tracing.snapshot()
        if path == "compiled":
            assert len(call.entries) == 1
    assert snap["counters"]["risk.quadrature.cells"] == 2 * cells
    assert snap["device_counters"]["risk.quadrature.useful"] == 2 * useful


# ------------------------------------------------------------------ (d)


def test_device_count_makes_nothing_with_tracing_off():
    ro, preds = _near_far_invalid()
    made = dict(tracing._DEVICE)
    tracing.device_count("test.ones", torch.ones(3, dtype=torch.int64).sum())
    collision_probability_fast(ro, preds, VehicleParams())
    assert tracing._DEVICE == made
    assert ("test.ones", torch.device("cpu")) not in made
    snap = tracing.snapshot()
    assert "test.ones" not in snap["device_counters"] and snap["spans"] == {}
    assert snap["counters"]["risk.quadrature.cells"] > 0      # host counters stay on


# ------------------------------------------------------------------ (e)


class _Event:
    """A stand-in for a timing event pair's end: `elapsed_time` from a
    start reads `ms`."""

    def __init__(self, ms=0.0):
        self.ms, self.waited = ms, 0

    def synchronize(self):
        self.waited += 1

    def elapsed_time(self, end):
        return end.ms


def test_snapshot_and_reset_round_trip():
    start, end = _Event(), _Event(2.5)
    spans = tracing.DeviceSpans([("test.span", start, end)])
    with tracing.on():
        tracing.count("test.host", 4)
        tracing.device_count("test.device", torch.tensor(7))
        tracing.device_count("test.device", torch.tensor(5))
        for _ in range(3):
            spans.fold()          # what a replay does before it replays
            spans.replayed()
        snap = tracing.snapshot()
    assert snap["spans"] == {"test.span": (7.5, 3)}
    assert snap["counters"] == {"test.host": 4}
    assert snap["device_counters"]["test.device"] == 12
    assert end.waited == 3
    assert tracing.snapshot() == snap                     # folds nothing twice
    spans.replayed()
    tracing.reset()
    cleared = tracing.snapshot()
    assert cleared["spans"] == {} and cleared["counters"] == {}
    assert set(cleared["device_counters"].values()) == {0}
    spans.fold()                                          # dropped by reset
    assert tracing.snapshot()["spans"] == {}


def test_a_switch_makes_every_entry_capture_again_at_its_next_call():
    """Each entry is given the graph a capture on the card would leave; a
    call under the other tracing state drops the entry and captures again."""
    program = _program()

    def captures_after_a_call():
        program(torch.ones(2), scale=1.0)
        for entry in program.entries.values():
            if entry.graph is None:
                entry.graph = _captured({}, traced=tracing.enabled())
        assert len(program.entries) == 1
        return program.captures

    assert captures_after_a_call() == 1
    with tracing.on():
        assert tracing.enabled() and program.entries          # dropped at the call
        assert captures_after_a_call() == 2
        with tracing.on():
            assert captures_after_a_call() == 2               # no switch, no capture
    assert not tracing.enabled()
    assert captures_after_a_call() == 3
    tracing.disable()
    assert captures_after_a_call() == 3


def test_span_is_one_shared_no_op_with_tracing_off():
    assert tracing.span("a") is tracing.span("b") is tracing.device_span("c")
    with tracing.on():
        assert tracing.span("a") is not tracing.span("a")
    assert isinstance(tracing.span("a"), type(tracing._NOOP))


# ------------------------------------------------------------------ layering

PORT = Path(__file__).resolve().parents[1] / "frenetix_tpu_torch"


@functools.cache
def _sources() -> dict:
    """The port's modules, path under the package → parsed source."""
    return {p.relative_to(PORT).as_posix(): ast.parse(p.read_text(encoding="utf-8"))
            for p in sorted(PORT.rglob("*.py"))}


def _port_imports(tree) -> set:
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and (node.module or "").startswith(PORT.name):
            names |= {f"{node.module}.{a.name}" for a in node.names}
        elif isinstance(node, ast.Import):
            names |= {a.name for a in node.names if a.name.startswith(PORT.name)}
    return names


def _captures(tree) -> bool:
    """`tree` names `torch.cuda.CUDAGraph` or `torch.cuda.graph`."""
    for node in ast.walk(tree):
        if (isinstance(node, ast.Attribute) and node.attr in ("CUDAGraph", "graph")
                and ast.unparse(node.value) == "torch.cuda"):
            return True
        if isinstance(node, ast.ImportFrom) and node.module == "torch.cuda" and any(
                a.name in ("CUDAGraph", "graph") for a in node.names):
            return True
    return False


def _globals(tree) -> set:
    names = set()
    for node in tree.body:
        targets = node.targets if isinstance(node, ast.Assign) else (
            [node.target] if isinstance(node, (ast.AnnAssign, ast.AugAssign)) else [])
        names |= {t.id for t in targets if isinstance(t, ast.Name)}
    return names


# rule → (what the sources show, what the rule wants)
LAYERING = {
    "tracing imports nothing of the port": lambda src: (
        _port_imports(src["utils/tracing.py"]), set()),
    "compiled imports only tracing of the port": lambda src: (
        _port_imports(src["utils/compiled.py"]), {"frenetix_tpu_torch.utils.tracing"}),
    "only compiled captures a CUDA graph": lambda src: (
        {m for m, tree in src.items() if _captures(tree)}, {"utils/compiled.py"}),
    "no module keeps a LAUNCHES global": lambda src: (
        {m for m, tree in src.items() if "LAUNCHES" in _globals(tree)}, set()),
}


@pytest.mark.parametrize("rule", list(LAYERING))
def test_graphs_and_counters_have_one_home_in_the_sources(rule):
    got, want = LAYERING[rule](_sources())
    assert got == want, rule


# ------------------------------------------------------------------ card


@pytest.mark.cuda
def test_device_span_in_a_graph_is_timed_at_each_replay(cuda_device):
    """A compiled body with a device span around part of its work: after
    replays the span's mean lies in (0, the whole call's CUDA-event time],
    nothing is captured again, and the host and device counters in the body
    count per replay as the eager twin counts per call."""
    @C.compiled
    def body(x):
        y = x * 2.0
        with tracing.device_span("test.part"):
            for _ in range(20):
                y = torch.sin(y) * 1.0001 + 0.5
        tracing.count("test.calls", 1)
        tracing.device_count("test.positive", (y > 0).sum())
        return y + 1.0

    x = torch.linspace(-3.0, 3.0, 1 << 22, device=cuda_device)
    with tracing.on():
        with C.disable_compiled():
            eager = body(x)
        torch.cuda.synchronize()
        twin = tracing.snapshot()
        assert twin["counters"]["test.calls"] == 1 and "test.part" not in twin["spans"]
        body(x)                                           # captures
        tracing.reset()
        captures = C.CAPTURES
        whole = []
        for _ in range(5):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            got = body(x)
            end.record()
            torch.cuda.synchronize()
            whole.append(start.elapsed_time(end))
        snap = tracing.snapshot()
    assert C.CAPTURES == captures
    total, n = snap["spans"]["test.part"]
    assert n == 5 and 0.0 < total / n <= sum(whole) / len(whole)
    assert snap["counters"]["test.calls"] == 5
    assert snap["device_counters"]["test.positive"] == \
        5 * twin["device_counters"]["test.positive"]
    assert torch.equal(got, eager)
