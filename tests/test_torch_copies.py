"""The port's own copies of the JAX package's JAX-free host modules.

`frenetix_tpu_torch` imports nothing of `frenetix_tpu`; it carries copies of
`geometry/refpath.py`, `geometry/corridor.py`, `ops/sampling.py`,
`io/commonroad.py` and `io/scenario_factory.py`.  Each test feeds the same
inputs, made from a seed with NumPy, to the original and to the copy and
asks for equal arrays (exact: the copies run the same NumPy expressions), so
a copy cannot drift unnoticed.
"""
import dataclasses
import inspect

import numpy as np
import pytest

from frenetix_tpu.geometry import corridor as jcorridor
from frenetix_tpu.geometry import refpath as jrefpath
from frenetix_tpu.io import commonroad as jcr
from frenetix_tpu.io import scenario_factory as jfactory
from frenetix_tpu.ops import sampling as jsampling
from frenetix_tpu_torch.geometry import corridor as tcorridor
from frenetix_tpu_torch.geometry import refpath as trefpath
from frenetix_tpu_torch.io import commonroad as tcr
from frenetix_tpu_torch.io import commonroad_writer
from frenetix_tpu_torch.io import scenario_factory as tfactory
from frenetix_tpu_torch.ops import sampling as tsampling


def _wavy_polyline(seed):
    rng = np.random.default_rng(seed)
    x = np.cumsum(rng.uniform(0.5, 3.0, 120))
    y = 8.0 * np.sin(x / 25.0) + np.cumsum(rng.normal(0, 0.05, 120))
    return np.stack([x, y], axis=1)


def _assert_equal_values(a, b, what=""):
    """Recursive equality of dataclasses, containers and arrays."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, what
        for f in dataclasses.fields(a):
            _assert_equal_values(getattr(a, f.name), getattr(b, f.name),
                                 f"{what}.{f.name}")
    elif isinstance(a, dict):
        assert list(a) == list(b), what
        for k in a:
            _assert_equal_values(a[k], b[k], f"{what}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_equal_values(x, y, f"{what}[{i}]")
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=what)
    else:
        assert a == b, what


@pytest.mark.parametrize("kw", [
    dict(), dict(smooth=True), dict(extension=0.0, resample_step=0.5),
    dict(dtype=np.float32, smooth=True),
])
def test_refpath_copy_equals_original(kw):
    poly = _wavy_polyline(1)
    want = jrefpath.prepare_reference_path(poly, **kw)
    got = trefpath.prepare_reference_path(poly, **kw)
    assert want._fields == got._fields
    for f in want._fields:
        a, b = getattr(want, f), getattr(got, f)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(b, a, err_msg=f)
    assert got.length == want.length
    for name in ("polyline_pathlength", "polyline_orientation", "polyline_curvature"):
        np.testing.assert_array_equal(getattr(trefpath, name)(poly),
                                      getattr(jrefpath, name)(poly), err_msg=name)
    np.testing.assert_array_equal(trefpath.resample_polyline(poly, 0.7),
                                  jrefpath.resample_polyline(poly, 0.7))
    assert trefpath.__all__ == jrefpath.__all__


@pytest.mark.parametrize("family", ["curve", "lane_merge", "intersection_crossing",
                                    "convoy"])
def test_corridor_copy_equals_original(family):
    """The copy's NumPy scan against the original (which may take its
    compiled route): equal corridors, and equal point-in-polygon masks."""
    sc = getattr(jfactory, f"make_{family}")()
    polys = sc.drivable_polygons()
    center = np.asarray(next(iter(sc.lanelets.values())).center_vertices)
    ref = jrefpath.prepare_reference_path(center, smooth=True)
    np.testing.assert_array_equal(tcorridor.corridor_from_polygons(ref, polys),
                                  jcorridor.corridor_from_polygons(ref, polys))
    np.testing.assert_array_equal(tcorridor.strip_corridor(ref, 3.5),
                                  jcorridor.strip_corridor(ref, 3.5))
    lanelets = list(sc.lanelets.values())
    np.testing.assert_array_equal(tcorridor.corridor_from_lanelets(ref, lanelets),
                                  jcorridor.corridor_from_lanelets(ref, lanelets))
    rng = np.random.default_rng(2)
    lo, hi = np.concatenate(polys).min(0) - 5.0, np.concatenate(polys).max(0) + 5.0
    pts = rng.uniform(lo, hi, size=(4000, 2))
    want = jcorridor._points_in_polygons(pts, polys)
    np.testing.assert_array_equal(tcorridor._points_in_polygons(pts, polys), want)
    np.testing.assert_array_equal(
        tcorridor._points_in_polygons(pts, polys, chunk=97), want)
    assert want.any() and not want.all()


def test_sampling_copy_equals_original():
    for level in (1, 2, 3, 5):
        np.testing.assert_array_equal(tsampling.time_samples(1.1, 3.0, 0.1, level),
                                      jsampling.time_samples(1.1, 3.0, 0.1, level))
        np.testing.assert_array_equal(tsampling.linspace_samples(-3.0, 3.0, level),
                                      jsampling.linspace_samples(-3.0, 3.0, level))
    kw = dict(t1_vals=[1.1, 2.0, 3.0], ss1_vals=np.linspace(5, 15, 5),
              d1_vals=np.linspace(-3, 3, 7), x0_lon=(30.0, 10.0, 0.3),
              x0_lat=(0.2, 0.1, 0.0))
    for dtype in (np.float32, np.float64):
        want = jsampling.build_sampling_matrix(**kw, dtype=dtype)
        got = tsampling.build_sampling_matrix(**kw, dtype=dtype)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        for bucket in (64, 256):
            (wm, wk), (gm, gk) = (jsampling.pad_matrix(want, bucket),
                                  tsampling.pad_matrix(got, bucket))
            np.testing.assert_array_equal(gm, wm)
            np.testing.assert_array_equal(gk, wk)
    assert tsampling.__all__ == jsampling.__all__


def test_commonroad_point_in_ring_copy_equals_original():
    rng = np.random.default_rng(3)
    ring = np.array([[0.0, 0.0], [6.0, 0.5], [7.0, 4.0], [3.0, 2.0], [-1.0, 5.0]])
    pts = np.concatenate([rng.uniform(-2, 8, size=(2000, 2)), ring,
                          (ring + np.roll(ring, -1, axis=0)) / 2])
    want = [jcr._point_in_ring(p, ring) for p in pts]
    got = [tcr._point_in_ring(p, ring) for p in pts]
    assert got == want and any(want) and not all(want)


def test_commonroad_reader_copy_equals_original(tmp_path):
    """A scenario written as CommonRoad XML (by the port's writer) reads back
    the same through the original reader and the copy."""
    path = str(tmp_path / "scenario.xml")
    commonroad_writer.write_scenario(tfactory.make_overtake(), path)
    want, got = jcr.load_scenario(path), tcr.load_scenario(path)
    _assert_equal_values(want, got, "scenario")
    assert got.dynamic_obstacles and got.planning_problems
    p = np.array([30.0, 0.5])
    assert got.find_lanelets_by_position(p) == want.find_lanelets_by_position(p)


_FAMILIES = sorted(n for n in dir(jfactory) if n.startswith("make_"))


@pytest.mark.parametrize("name", _FAMILIES)
def test_scenario_family_copy_equals_original(name):
    want, got = getattr(jfactory, name)(), getattr(tfactory, name)()
    assert (inspect.signature(getattr(jfactory, name))
            == inspect.signature(getattr(tfactory, name)))
    _assert_equal_values(want, got, name)
    assert type(got).__module__ == "frenetix_tpu_torch.io.commonroad"


def test_factory_copy_brings_every_family():
    assert sorted(n for n in dir(tfactory) if n.startswith("make_")) == _FAMILIES
    assert {"make_highway", "make_overtake", "make_convoy"} <= set(_FAMILIES)
    from frenetix_tpu_torch.run_scenario import FAMILIES

    assert sorted("make_" + f for f in FAMILIES) == _FAMILIES
