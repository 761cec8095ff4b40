"""The port's evaluation modules against the JAX package's, at float64.

Both sides are NumPy (the port's copies carry no JAX), so every comparison
is exact unless it says otherwise:
- `Measures`: every criticality metric, column by column, on the cases of
  `tests/test_evaluation.py` (a slower lead car, the straight and the curved
  lead search, the junction conflict area, a junction-free road, a passed
  standing car, future-cumulative TIT/TET) and on a two-agent case; the
  port's `MetricTable` against the JAX DataFrame (index, columns, values).
- `check_solution`, `partial_costs` / `benchmark_cost` and
  `solution_to_xml` / `write_solution` / `read_solution` on the cases of
  `tests/test_solution_export.py`; the XML byte for byte with the date
  given (the date stamp is the only field that depends on the day).
- `write_scenario` byte for byte on every scenario family.
- `collision_report`'s dict on crafted collisions with a car, a
  pedestrian, a bicycle and no partner: harms within 1e-12 (the JAX side
  runs its harm functions in jax.numpy float64, the port in torch); the
  JSON report without matplotlib, with one warning naming it.
"""
import datetime
import json
import logging
import sys
from types import SimpleNamespace

import numpy as np
import pytest

from frenetix_tpu_torch.evaluation import metrics as tmetrics
from frenetix_tpu_torch.evaluation import solution_check as tcheck
from frenetix_tpu_torch.evaluation import solution_cost as tcost
from frenetix_tpu_torch.io import commonroad_writer as twriter
from frenetix_tpu_torch.io import solution_writer as tsol


def _pkg(port: bool):
    """(commonroad, scenario_factory, EgoState) of one package."""
    if port:
        from frenetix_tpu_torch.io import commonroad, scenario_factory
        from frenetix_tpu_torch.sim.agent import EgoState
    else:
        from frenetix_tpu.io import commonroad, scenario_factory
        from frenetix_tpu.sim.agent import EgoState
    return commonroad, scenario_factory, EgoState


class _S:
    def __init__(self, t, x, y, th, v, a=0.0, yr=0.0, sa=0.0):
        self.time_step = t
        self.position = np.array([x, y])
        self.orientation = th
        self.velocity = v
        self.acceleration = a
        self.yaw_rate = yr
        self.steering_angle = sa


def _straight_drive(n=40, v=10.0, dt=0.1):
    return [_S(i, v * dt * i, 0.0, 0.0, v) for i in range(n)]


def _lead_scenario(cr, x0, v, n, y=0.0, still=False):
    dt = 0.1
    st = [cr.State(i, np.array([x0 + (0.0 if still else v * dt * i), y]), 0.0,
                   0.0 if still else v) for i in range(n)]
    ob = cr.Obstacle(obstacle_id=7, obstacle_type="car", role="dynamic", length=4.5,
                     width=2.0, initial_state=st[0], trajectory=st[1:])
    return cr.Scenario("t", dt, {}, {7: ob}, {})


def _case(name, port):
    """(agent_id, scenario, states, other_histories, Measures kwargs)."""
    cr, fac, Ego = _pkg(port)
    dt = 0.1

    def straight(xs, v):
        return [Ego(i, np.array([x, 0.0]), 0.0, v) for i, x in enumerate(xs)]

    if name == "ttc_headway":
        return 1, _lead_scenario(cr, 30.0, 5.0, 60), _straight_drive(50), None, dict(dt=dt)
    if name == "straight_chain":
        sc = fac.make_highway(lead_v=10.0, lead_gap=40.0)
        return 60000, sc, straight(np.arange(0.0, 10.0, 1.0), 10.0), None, \
            dict(veh_length=4.508, veh_width=1.61)
    if name == "curved_chain":
        sc = fac.make_curve(radius=80.0, lead_v=8.0)
        return 60000, sc, [Ego(0, sc.lanelets[50000].center_vertices[0].copy(), 0.0, 8.0)], \
            None, {}
    if name == "conflict_area":
        sc = fac.make_intersection_crossing(ego_v=10.0, cross_v=8.0, cross_delay=48.0)
        states = [Ego(i, np.array([-58.0 + 10.0 * dt * i, 0.0]), 0.0, 10.0)
                  for i in range(115)]
        return 60000, sc, states, None, dict(dt=dt, veh_length=4.508, veh_width=1.61)
    if name == "no_intersection":
        return 60000, fac.make_highway(), straight(np.arange(5.0), 10.0), None, {}
    if name == "passed_standing_car":
        sc = _lead_scenario(cr, 30.0, 0.0, 70, y=3.0, still=True)
        return 1, sc, straight(np.arange(0.0, 60.0, 1.0), 10.0), None, dict(dt=dt)
    if name == "tit_tet":
        sc = _lead_scenario(cr, 20.0, 2.0, 50)
        return 1, sc, straight(np.arange(0.0, 45.0, 1.0), 10.0), None, dict(dt=dt)
    if name == "two_agents":
        sc = fac.make_highway(lead_v=10.0, lead_gap=40.0)
        rng = np.random.default_rng(7)
        xs = np.cumsum(rng.uniform(0.9, 1.4, 60))
        a = [Ego(i, np.array([x, rng.normal(0, 0.05)]), rng.normal(0, 0.01),
                 12.0 + rng.normal(0, 0.3), rng.normal(0, 0.5), rng.normal(0, 0.02))
             for i, x in enumerate(xs)]
        b = [Ego(i, np.array([x + 25.0, 0.0]), 0.0, 9.0) for i, x in enumerate(xs)]
        return 60000, sc, a, {60000: a, 61000: b}, dict(dt=dt, tau=3.0, radius=80.0)
    raise KeyError(name)


_CASES = ["ttc_headway", "straight_chain", "curved_chain", "conflict_area",
          "no_intersection", "passed_standing_car", "tit_tet", "two_agents"]


@pytest.mark.parametrize("name", _CASES)
def test_measures_match_jax_column_by_column(name):
    from frenetix_tpu.evaluation.metrics import CRITICALITY_METRICS, Measures

    assert tmetrics.CRITICALITY_METRICS == CRITICALITY_METRICS
    aid, sc, states, others, kw = _case(name, port=False)
    want = Measures(aid, sc, states, other_histories=others, **kw).compute()
    aid, sc, states, others, kw = _case(name, port=True)
    got = tmetrics.Measures(aid, sc, states, other_histories=others, **kw).compute()
    assert isinstance(got, tmetrics.MetricTable)
    assert list(got.columns) == list(want.columns) == CRITICALITY_METRICS
    np.testing.assert_array_equal(got.index, want.index.to_numpy())
    for m in CRITICALITY_METRICS:
        np.testing.assert_array_equal(got[m], want[m].to_numpy(), err_msg=m)
    for (ts_g, row_g), (ts_w, row_w) in zip(got.iterrows(), want.iterrows()):
        assert ts_g == ts_w
        for m in CRITICALITY_METRICS:
            assert (row_g[m] == row_w[m]) or (np.isnan(row_g[m]) and np.isnan(row_w[m]))


def test_measures_subset_and_nan_on_error_as_jax():
    from frenetix_tpu.evaluation.metrics import Measures, enabled_metrics

    for toggles in ({}, {"tit": False, "pet": False}):
        assert tmetrics.enabled_metrics(toggles) == enabled_metrics(toggles)
    with pytest.raises(ValueError, match="ttcc"):
        tmetrics.enabled_metrics({"ttcc": True})
    aid, sc, states, others, kw = _case("ttc_headway", port=False)
    jm = Measures(aid, sc, states, **kw)
    aid, sc, states, others, kw = _case("ttc_headway", port=True)
    tm = tmetrics.Measures(aid, sc, states, **kw)
    for m in (jm, tm):
        m.hw = lambda: 1 / 0          # a metric that raises is a NaN column
    want, got = jm.compute(["hw", "v", "ttc"]), tm.compute(["hw", "v", "ttc"])
    assert got.columns == ["hw", "v", "ttc"] and len(got) == len(want)
    assert np.isnan(got["hw"]).all() and np.isnan(want["hw"].to_numpy()).all()
    np.testing.assert_array_equal(got["v"], want["v"].to_numpy())
    np.testing.assert_array_equal(got["ttc"], want["ttc"].to_numpy())


# ------------------------------------------------------ solution check + cost


def _check_cases():
    straight = _straight_drive()
    teleport = _straight_drive()
    teleport[20].position = teleport[20].position + np.array([0.0, 3.0])
    accel = _straight_drive()
    for i, s in enumerate(accel):
        s.velocity = 10.0 + (2.0 * i if i > 20 else 0.0)
    rng = np.random.default_rng(3)
    wavy, x, y, th, v, delta = [], 0.0, 0.0, 0.0, 8.0, 0.0
    for i in range(50):
        wavy.append(_S(i, x, y, th, v, a=rng.normal(0, 0.5), sa=delta))
        delta = float(np.clip(delta + rng.normal(0, 0.01), -0.3, 0.3))
        v = max(0.0, v + rng.normal(0, 0.2))
        th += v * np.tan(delta) / 2.578 * 0.1
        x += v * np.cos(th) * 0.1
        y += v * np.sin(th) * 0.1
    return {"straight": straight, "teleport": teleport, "accel": accel,
            "wavy": wavy, "short": straight[:1]}


@pytest.mark.parametrize("case", ["straight", "teleport", "accel", "wavy", "short"])
@pytest.mark.parametrize("vid", [None, 1, 3])
def test_check_solution_matches_jax(case, vid):
    from frenetix_tpu.evaluation.solution_check import check_solution
    from frenetix_tpu.ops.kinematics import VehicleParams as JVeh
    from frenetix_tpu.ops.vehicle_db import resolve_vehicle as jresolve
    from frenetix_tpu_torch.ops.kinematics import VehicleParams as TVeh
    from frenetix_tpu_torch.ops.vehicle_db import resolve_vehicle

    states = _check_cases()[case]
    jveh = JVeh() if vid is None else jresolve(vid)
    tveh = TVeh() if vid is None else resolve_vehicle(vid)
    want = check_solution(states, jveh, 0.1)
    got = tcheck.check_solution(states, tveh, 0.1)
    assert got.__dict__ == want.__dict__


@pytest.mark.parametrize("case", ["straight", "teleport", "accel", "wavy", "short"])
def test_partial_and_benchmark_costs_match_jax(case):
    from frenetix_tpu.evaluation.solution_cost import (
        COST_COMBINATIONS, benchmark_cost, partial_costs)

    assert tcost.COST_COMBINATIONS == COST_COMBINATIONS
    states = _check_cases()[case]
    for v_des in (None, 10.0):
        assert tcost.partial_costs(states, 0.1, v_des) == partial_costs(states, 0.1, v_des)
        for name in COST_COMBINATIONS:
            assert (tcost.benchmark_cost(states, 0.1, name, desired_velocity=v_des)
                    == benchmark_cost(states, 0.1, name, desired_velocity=v_des))
    w = {"time": 10.0, "velocity_offset": 1.0, "acceleration": 0.1, "steering_rate": 0.1}
    assert tcost.benchmark_cost(states, 0.1, "WX1", weights=w) \
        == benchmark_cost(states, 0.1, "WX1", weights=w)
    with pytest.raises(ValueError):
        tcost.benchmark_cost([], 0.1, "NOPE")


def _xml_states():
    rng = np.random.default_rng(11)
    return [SimpleNamespace(position=(float(x), float(rng.normal())),
                            orientation=float(rng.normal(0, 0.1)),
                            velocity=float(rng.uniform(5, 15)),
                            steering_angle=float(rng.normal(0, 0.05)), time_step=i)
            for i, x in enumerate(np.cumsum(rng.uniform(0.5, 1.5, 30)))]


@pytest.mark.parametrize("kw", [
    {}, {"cost_weights": {"time": 10.0, "velocity_offset": 1.0}},
    {"computation_time": 1.25, "cr_vehicle_id": 3, "cost_function": "SM1"},
    {"vehicle_model": "PM"},
])
def test_solution_xml_matches_jax_byte_for_byte(tmp_path, kw):
    import xml.etree.ElementTree as ET

    from frenetix_tpu.io import solution_writer as jsol

    trajs = {7: _xml_states(), 9: _xml_states()[:5]}
    want = ET.tostring(jsol.solution_to_xml("TEST-1", trajs, 0.1, date="2024-05-05", **kw))
    got = ET.tostring(tsol.solution_to_xml("TEST-1", trajs, 0.1, date="2024-05-05", **kw))
    assert got == want
    jp = jsol.write_solution(str(tmp_path / "j.xml"), "TEST-1", trajs, 0.1,
                             date="2024-05-05", **kw)
    tp = tsol.write_solution(str(tmp_path / "t.xml"), "TEST-1", trajs, 0.1,
                             date="2024-05-05", **kw)
    assert open(tp, "rb").read() == open(jp, "rb").read()
    jid, jback = jsol.read_solution(jp, dt=0.1)
    tid, tback = tsol.read_solution(tp, dt=0.1)
    assert tid == jid == tsol.benchmark_id("TEST-1", **{
        k: v for k, v in kw.items() if k in ("cr_vehicle_id", "cost_function",
                                             "vehicle_model")})
    assert {k: [s.__dict__ for s in v] for k, v in tback.items()} \
        == {k: [s.__dict__ for s in v] for k, v in jback.items()}
    # the date defaults to the day of writing
    root = tsol.solution_to_xml("TEST-1", trajs, 0.1)
    assert root.get("date") == datetime.date.today().isoformat()


# ------------------------------------------------------------ scenario XML


def _families():
    from frenetix_tpu.io import scenario_factory

    return sorted(n[len("make_"):] for n in dir(scenario_factory) if n.startswith("make_"))


@pytest.mark.parametrize("family", _families())
def test_write_scenario_byte_for_byte(tmp_path, family):
    from frenetix_tpu.io import commonroad_writer as jwriter
    from frenetix_tpu.io import scenario_factory as jfac
    from frenetix_tpu_torch.io import scenario_factory as tfac

    jwriter.write_scenario(getattr(jfac, f"make_{family}")(), str(tmp_path / "j.xml"))
    twriter.write_scenario(getattr(tfac, f"make_{family}")(), str(tmp_path / "t.xml"))
    assert (tmp_path / "t.xml").read_bytes() == (tmp_path / "j.xml").read_bytes()


# -------------------------------------------------------- collision report


def _collision(port, partner_type, dt_pos=(2.5, 0.8)):
    cr, _, Ego = _pkg(port)
    st = Ego(42, np.array([30.0, 0.2]), 0.15, 12.0)
    agent = SimpleNamespace(id=60000, state=st,
                            record=SimpleNamespace(states=[
                                Ego(i, np.array([30.0 - 1.2 * (42 - i), 0.2]), 0.15, 12.0)
                                for i in range(30, 43)]))
    obstacles = {}
    if partner_type is not None:
        pos = np.array([30.0 + dt_pos[0], 0.2 + dt_pos[1]])
        traj = [cr.State(t, pos + np.array([0.5 * (t - 42), 0.0]), 2.4, 5.0)
                for t in range(40, 46)]
        obstacles[5] = cr.Obstacle(obstacle_id=5, obstacle_type=partner_type,
                                   role="dynamic", length=4.6 if partner_type != "pedestrian"
                                   else 0.5, width=1.9 if partner_type != "pedestrian" else 0.5,
                                   initial_state=traj[0], trajectory=traj[1:])
    return agent, cr.Scenario("c", 0.1, {}, obstacles, {})


@pytest.mark.parametrize("partner_type", ["car", "truck", "pedestrian", "bicycle",
                                          "pillar", None])
def test_collision_report_matches_jax(tmp_path, partner_type):
    from frenetix_tpu.evaluation.collision_report import collision_report as jreport
    from frenetix_tpu.ops.kinematics import VehicleParams as JVeh
    from frenetix_tpu_torch.evaluation.collision_report import collision_report
    from frenetix_tpu_torch.ops.kinematics import VehicleParams as TVeh

    ja, jsc = _collision(False, partner_type)
    ta, tsc = _collision(True, partner_type)
    want = jreport(ja, jsc, JVeh(), log_dir=str(tmp_path / "j"))
    got = collision_report(ta, tsc, TVeh(), log_dir=str(tmp_path / "t"))
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, float):
            assert got[k] == pytest.approx(v, rel=1e-12, abs=1e-12), k
        else:
            assert got[k] == v, k
    if partner_type is not None:
        assert 0.0 < got["ego_harm"] <= 1.0
    on_disk = json.loads((tmp_path / "t" / "collision_report_agent_60000.json").read_text())
    assert on_disk == json.loads(json.dumps(got))


def test_collision_report_without_matplotlib(tmp_path, monkeypatch, caplog):
    from frenetix_tpu_torch.evaluation.collision_report import collision_report
    from frenetix_tpu_torch.ops.kinematics import VehicleParams

    monkeypatch.setitem(sys.modules, "matplotlib", None)   # import raises
    agent, sc = _collision(True, "car")
    with caplog.at_level(logging.WARNING):
        rep = collision_report(agent, sc, VehicleParams(), log_dir=str(tmp_path))
    assert rep["partner_id"] == 5
    assert (tmp_path / "collision_report_agent_60000.json").exists()
    assert not (tmp_path / "collision_agent_60000.png").exists()
    warnings = [r for r in caplog.records if r.levelno == logging.WARNING]
    assert len(warnings) == 1 and "matplotlib" in warnings[0].getMessage()


def test_collision_report_draws_the_crash_with_matplotlib(tmp_path):
    pytest.importorskip("matplotlib")
    from frenetix_tpu_torch.evaluation.collision_report import collision_report
    from frenetix_tpu_torch.io.scenario_factory import make_highway
    from frenetix_tpu_torch.ops.kinematics import VehicleParams

    agent, _ = _collision(True, "car")
    sc = make_highway()
    sc.obstacles[5] = _collision(True, "car")[1].obstacles[5]
    collision_report(agent, sc, VehicleParams(), log_dir=str(tmp_path))
    assert (tmp_path / "collision_agent_60000.png").stat().st_size > 1000
