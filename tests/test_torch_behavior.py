"""The port's behavior planner on the host, held against the JAX package.

`frenetix_tpu_torch.behavior` holds NumPy copies of the JAX package's
behavior modules (frame, static route, velocity planner, path planner, FSM,
behavior module) and `sim.world_view`; `sim.planner_interfaces` ports
`apply_behavior_output`.  Each test feeds the same scenario or the same
scripted ego states, made with NumPy, to both packages at float64:

- static route plans on seven behavior families: goal types and order
  equal, s-bounds and stop points within 1e-12;
- the velocity planner (MAX and TTC modes, the four relative-motion
  situations of the safety distance) on a grid, within 1e-12;
- `HostFrame` projections and round trips, and `PathPlanner`'s lane-change
  paths, within 1e-12;
- `EgoFSM` on scripted sequences: equal state names step by step;
- `apply_behavior_output`: the reference-path swap, the recomputed
  curvilinear state (1e-12) and the rear-axle shift of the stop point;
- `WorldView`: live agents replace their stale recordings;
- the behavior section of the config read from a behavior.yaml.
"""
import dataclasses

import numpy as np
import pytest
import torch

from frenetix_tpu_torch.behavior import BehaviorModule as TBehaviorModule
from frenetix_tpu_torch.behavior.behavior_module import BehaviorOutput as TBehaviorOutput
from frenetix_tpu_torch.behavior.behavior_module import BMState as TBMState
from frenetix_tpu_torch.behavior.frame import HostFrame as THostFrame
from frenetix_tpu_torch.behavior.velocity_planner import VelocityPlanner as TVelocityPlanner
from frenetix_tpu_torch.io import scenario_factory as tfactory
from frenetix_tpu_torch.planner.route import reference_path_for_problem as troute
from frenetix_tpu_torch.utils import config as tconfig

torch.set_num_threads(1)

TOL = 1e-12


def _modules(family, **factory_kw):
    """The behavior module of the family's ego in both packages."""
    from frenetix_tpu.behavior import BehaviorModule as JBehaviorModule
    from frenetix_tpu.io import scenario_factory as jfactory
    from frenetix_tpu.planner.route import reference_path_for_problem as jroute
    from frenetix_tpu.utils.config import FrenetixConfig as JConfig

    out = []
    for factory, route, module, cfg in (
            (jfactory, jroute, JBehaviorModule, JConfig(dtype="float64")),
            (tfactory, troute, TBehaviorModule, tconfig.FrenetixConfig(dtype="float64"))):
        cfg.behavior.use_behavior_planner = True
        sc = getattr(factory, f"make_{family}")(**factory_kw)
        pp = list(sc.planning_problems.values())[0]
        polyline, ids = route(sc, pp)
        out.append(module(sc, pp, cfg, polyline, ids, ego_id=pp.problem_id))
    return out


# ------------------------------------------------------------- static route


@pytest.mark.parametrize("family", ["traffic_light", "lane_merge",
                                    "intersection_crossing", "turn_left", "turn_right",
                                    "road_exit", "crosswalk"])
def test_static_route_plan_matches_jax(family):
    jmod, tmod = _modules(family)
    jplan = jmod.bm.PP_state.static_route_plan
    tplan = tmod.bm.PP_state.static_route_plan
    assert [g.goal_type for g in tplan] == [g.goal_type for g in jplan]
    assert len(tplan) > 1, "the family's goals were not detected"
    for jg, tg in zip(jplan, tplan):
        assert abs(tg.start_s - jg.start_s) <= TOL and abs(tg.end_s - jg.end_s) <= TOL
        assert (tg.stop_point_s is None) == (jg.stop_point_s is None)
        if jg.stop_point_s is not None:
            assert abs(tg.stop_point_s - jg.stop_point_s) <= TOL
        assert tg.goal_lanelet_id == jg.goal_lanelet_id
    assert (tmod.bm.nav_lane_changes_left, tmod.bm.nav_lane_changes_right) == \
        (jmod.bm.nav_lane_changes_left, jmod.bm.nav_lane_changes_right)
    assert tmod.bm.street_setting == jmod.bm.street_setting
    assert tmod.bm.PP_state.final_s_position_interval == pytest.approx(
        jmod.bm.PP_state.final_s_position_interval, abs=TOL)


# -------------------------------------------------------- velocity planner


def _vp(bm_cls, vp_cls, cfg, v_ego, v_lead, gap):
    class Ego:
        position = np.zeros(2)
        orientation = 0.0
        velocity = v_ego
        time_step = 0

    bm = bm_cls()
    bm.config = cfg
    bm.vehicle_params = cfg.vehicle
    bm.ego_state = Ego()
    bm.FSM_state.street_setting = "Urban"
    vp = vp_cls(bm)
    bm.VP_state.dist_preceding_veh = gap
    bm.VP_state.vel_preceding_veh = v_lead
    return vp, bm


_VP_FIELDS = ("desired_velocity", "goal_velocity", "velocity_mode", "TTC", "MAX",
              "comfortable_stopping_distance", "ttc_relative", "stop_dist_preceding_veh",
              "min_safety_dist", "safety_dist", "condition_factor")


@pytest.mark.parametrize("v_ego", [-3.0, 0.0, 5.0, 12.0, 30.0])
def test_velocity_planner_matches_jax(v_ego):
    """MAX (no lead), TTC (a close slow lead) and the four relative-motion
    situations of the safety distance (towards, ego behind, ego in front,
    moving apart), on a grid of lead velocities and gaps."""
    from frenetix_tpu.behavior.behavior_module import BMState as JBMState
    from frenetix_tpu.behavior.velocity_planner import VelocityPlanner as JVelocityPlanner
    from frenetix_tpu.utils.config import FrenetixConfig as JConfig

    modes = set()
    for v_lead in (None, -5.0, 0.0, 4.0, 15.0):
        for gap in ((None,) if v_lead is None else (-20.0, 8.0, 50.0)):
            jvp, jbm = _vp(JBMState, JVelocityPlanner, JConfig(dtype="float64"),
                           v_ego, v_lead, gap)
            tvp, tbm = _vp(TBMState, TVelocityPlanner,
                           tconfig.FrenetixConfig(dtype="float64"), v_ego, v_lead, gap)
            if gap is not None:
                assert tvp._calc_safety_distance() == jvp._calc_safety_distance()
            jvp.execute()
            tvp.execute()
            for f in _VP_FIELDS:
                a, b = getattr(jbm.VP_state, f), getattr(tbm.VP_state, f)
                what = f"{f} at v_ego={v_ego} v_lead={v_lead} gap={gap}"
                if isinstance(a, float):
                    assert b == pytest.approx(a, abs=TOL), what
                else:
                    assert b == a, what
            modes.add(tbm.VP_state.velocity_mode)
    assert "MAX" in modes


# ------------------------------------------------- frame and path planner


def test_host_frame_round_trips_match_jax():
    from frenetix_tpu.behavior.frame import HostFrame as JHostFrame

    rng = np.random.default_rng(3)
    x = np.cumsum(rng.uniform(0.5, 3.0, 80))
    poly = np.stack([x, 6.0 * np.sin(x / 20.0)], axis=1)
    jf, tf = JHostFrame(poly), THostFrame(poly)
    np.testing.assert_array_equal(tf.xy, jf.xy)
    np.testing.assert_array_equal(tf.s, jf.s)
    s = rng.uniform(0.0, tf.length, 200)
    d = rng.uniform(-3.0, 3.0, 200)
    pts_t, pts_j = tf.to_cartesian(s, d), jf.to_cartesian(s, d)
    np.testing.assert_allclose(pts_t, pts_j, rtol=0, atol=TOL)
    (s_t, d_t), (s_j, d_j) = tf.project(pts_t), jf.project(pts_j)
    np.testing.assert_allclose(s_t, s_j, rtol=0, atol=TOL)
    np.testing.assert_allclose(d_t, d_j, rtol=0, atol=TOL)
    # the round trip lands on the same point (a tight curve can map a point
    # to a nearer segment, so hold the points, not (s, d))
    np.testing.assert_allclose(tf.to_cartesian(s_t, d_t), pts_t, atol=2e-2)
    assert tf.project_s(pts_t[7]) == pytest.approx(jf.project_s(pts_j[7]), abs=TOL)


@pytest.mark.parametrize("x_ego", [20.0, 60.0, 110.0])
def test_path_planner_lane_change_matches_jax(x_ego):
    """`PathPlanner._create_lane_change` onto the left lane of the
    lane_change family from three ego positions."""
    jmod, tmod = _modules("lane_change")
    paths = []
    for mod in (jmod, tmod):
        bm = mod.bm
        bm.ego_state = type("Ego", (), dict(position=np.array([x_ego, 0.0]),
                                            velocity=12.0))()
        bm.future_factor = 4
        mod._collect_lanelet_information()
        target = bm.scenario.lanelets[bm.current_lanelet_id].adj_left
        mod.path_planner._create_lane_change(target)
        paths.append((bm.PP_state.reference_path, list(bm.PP_state.reference_path_ids)))
    (jpath, jids), (tpath, tids) = paths
    assert tids == jids
    assert tpath.shape == jpath.shape
    np.testing.assert_allclose(tpath, jpath, rtol=0, atol=TOL)


# ------------------------------------------------------------------ FSM


class _Ego:
    def __init__(self, x, v, t=0, y=0.0):
        self.position = np.array([float(x), float(y)])
        self.orientation = 0.0
        self.velocity = float(v)
        self.time_step = t


# (family, factory arguments, scripted (x, v, t) of the ego)
_SCRIPTS = {
    "traffic_light": ("traffic_light", {}, [(30.0, 10.0, 0), (60.0, 8.0, 15),
                                            (80.0, 5.0, 30), (85.0, 0.3, 33),
                                            (85.0, 0.0, 60), (85.0, 0.0, 93),
                                            (95.0, 4.0, 99), (120.0, 8.0, 120)]),
    "stop_sign": ("stop_sign", {}, [(30.0, 10.0, 0), (70.0, 6.0, 20), (84.0, 2.0, 40),
                                    (86.0, 0.2, 45)] + [(86.0, 0.0, 48 + 3 * i)
                                                        for i in range(6)]
                  + [(95.0, 4.0, 70), (120.0, 8.0, 90)]),
    "lane_change": ("lane_change", {"with_traffic": True},
                    [(60.0, 12.0, 3), (60.0, 12.0, 6), (75.0, 12.0, 9),
                     (95.0, 12.0, 12), (115.0, 12.0, 15)]),
    "crosswalk": ("crosswalk", {}, [(20.0, 9.0, 0), (40.0, 8.0, 15), (52.0, 3.0, 30),
                                    (55.0, 0.1, 40), (55.0, 0.0, 60), (70.0, 6.0, 90)]),
}

_FSM_FIELDS = ("street_setting", "behavior_state_static", "situation_state_static",
               "behavior_state_dynamic", "situation_state_dynamic",
               "lane_change_target_lanelet_id", "slowing_car_for_traffic_light",
               "waiting_for_green_light")


@pytest.mark.parametrize("script", sorted(_SCRIPTS))
def test_fsm_state_sequences_match_jax(script):
    family, kw, steps = _SCRIPTS[script]
    jmod, tmod = _modules(family, **kw)
    seen = set()
    for x, v, t in steps:
        jout = jmod.execute(None, _Ego(x, v, t), t)
        tout = tmod.execute(None, _Ego(x, v, t), t)
        for f in _FSM_FIELDS:
            assert getattr(tmod.bm.FSM_state, f) == getattr(jmod.bm.FSM_state, f), \
                f"{f} at step {t}"
        assert tout.desired_velocity == pytest.approx(jout.desired_velocity, abs=TOL)
        assert (tout.stop_point_s is None) == (jout.stop_point_s is None)
        if jout.stop_point_s is not None:
            assert tout.stop_point_s == pytest.approx(jout.stop_point_s, abs=TOL)
        assert tout.desired_velocity_stop_point == pytest.approx(
            jout.desired_velocity_stop_point, abs=TOL)
        assert (tout.reference_path is None) == (jout.reference_path is None)
        assert tmod.bm.stop_point_mode == jmod.bm.stop_point_mode
        seen.add(tuple(getattr(tmod.bm.FSM_state, f) for f in _FSM_FIELDS[1:5]))
    assert len(seen) > 1, "the script did not move the FSM"


# ------------------------------------------------ apply_behavior_output


def test_apply_behavior_output_swaps_and_shifts_like_jax():
    from frenetix_tpu.sim.agent import Agent as JAgent
    from frenetix_tpu.sim.planner_interfaces import apply_behavior_output as japply
    from frenetix_tpu.behavior.behavior_module import BehaviorOutput as JBehaviorOutput
    from frenetix_tpu.io import scenario_factory as jfactory
    from frenetix_tpu.utils.config import FrenetixConfig as JConfig
    from frenetix_tpu_torch.sim.agent import Agent as TAgent
    from frenetix_tpu_torch.sim.planner_interfaces import apply_behavior_output as tapply

    jcfg, tcfg = JConfig(dtype="float64"), tconfig.FrenetixConfig(dtype="float64")
    for cfg in (jcfg, tcfg):
        cfg.behavior.use_behavior_planner = True
    jsc, tsc = jfactory.make_lane_change(), tfactory.make_lane_change()
    (pid, jpp), (_, tpp) = (next(iter(s.planning_problems.items())) for s in (jsc, tsc))
    jagent = JAgent(pid, jpp, jsc, jcfg)
    tagent = TAgent(pid, tpp, tsc, tcfg, torch.device("cpu"))
    # a left-lane path: the ego's lane shifted by one lane width
    new_path = np.asarray(tagent.behavior.bm.PP_state.reference_path) + [0.0, 3.6]
    outs = []
    for agent, apply, out_cls in ((jagent, japply, JBehaviorOutput),
                                  (tagent, tapply, TBehaviorOutput)):
        agent.ensure_x_cl()
        out = out_cls(desired_velocity=9.5, reference_path=new_path,
                      stop_point_s=80.0, desired_velocity_stop_point=0.0)
        assert apply(agent, out) is True          # the swap
        assert apply(agent, out) is False         # the same output again: no rebuild
        outs.append(agent)
    ja, ta = outs
    assert ta.planner.stop_point == (80.0 - tcfg.vehicle.wb_rear_axle, 0.0)
    assert ta.planner.stop_point == pytest.approx(ja.planner.stop_point, abs=TOL)
    assert ta.planner.desired_velocity == ja.planner.desired_velocity == 9.5
    for part_t, part_j in zip(ta.x_cl, ja.x_cl):
        np.testing.assert_allclose(part_t, part_j, rtol=0, atol=TOL)
    # the curvilinear state is on the new path: the ego sits one lane right
    assert ta.x_cl[1][0] == pytest.approx(-3.6, abs=0.05)
    np.testing.assert_allclose(np.asarray(ta.planner.ref_np.xy),
                               np.asarray(ja.planner.ref_np.xy), rtol=0, atol=TOL)
    assert ta._goal_s == pytest.approx(ja._goal_s, abs=TOL)
    # without a stop point the planner's is cleared
    tapply(ta, TBehaviorOutput(desired_velocity=3.0))
    assert ta.planner.stop_point is None and ta.planner.desired_velocity == 3.0


# -------------------------------------------------------------- WorldView


def test_world_view_serves_live_agents_like_jax():
    """Agents appear with their executed states only (none for the future),
    scenario obstacles that are no agent pass through, and the observer is
    not among its own obstacles."""
    from frenetix_tpu.io import scenario_factory as jfactory
    from frenetix_tpu.sim.world_view import WorldView as JWorldView
    from frenetix_tpu_torch.sim.world_view import WorldView as TWorldView

    class Agent:
        def __init__(self, aid, xs):
            self.id = aid
            self.record = type("Record", (), {})()
            self.record.states = [type("S", (), dict(time_step=t, position=np.array([x, 0.0]),
                                                     velocity=5.0))()
                                  for t, x in enumerate(xs)]

    views = []
    for factory, view in ((jfactory, JWorldView), (tfactory, TWorldView)):
        sc = factory.make_convoy(n_vehicles=3)
        ids = [ob.obstacle_id for ob in sc.dynamic_obstacles]
        agents = [Agent(60000, [0.0, 1.0, 2.0]), Agent(ids[0], [30.0, 31.0])]
        views.append((view(sc, agents, exclude_id=60000), ids, agents))
    (jv, ids, _), (tv, _, agents) = views
    assert sorted(tv.obstacles) == sorted(jv.obstacles) == sorted(ids)
    assert [o.obstacle_id for o in tv.dynamic_obstacles] == \
        [o.obstacle_id for o in jv.dynamic_obstacles]
    live = tv.obstacles[ids[0]]
    assert live.state_at_time(1) is agents[1].record.states[1]
    assert live.state_at_time(2) is None        # no state beyond "now"
    # a passing-through obstacle keeps its recording; the scenario delegates
    assert tv.obstacles[ids[1]].state_at_time(5) is not None
    assert tv.lanelets is tv._scenario.lanelets
    assert (live.length, live.width) == (jv.obstacles[ids[0]].length,
                                         jv.obstacles[ids[0]].width)


# ----------------------------------------------------------------- config


@pytest.mark.parametrize("reader", ["pyyaml", "fallback"])
def test_behavior_section_loads_whole_from_behavior_yaml(tmp_path, monkeypatch, reader):
    """Every key of the JAX package's BehaviorConfig loads from a
    behavior.yaml (with PyYAML and with the port's own reader); a misspelled
    key raises in strict mode."""
    from frenetix_tpu.utils.config import BehaviorConfig as JBehaviorConfig

    values = {}
    for f in dataclasses.fields(JBehaviorConfig):
        d = f.default
        values[f.name] = (not d if isinstance(d, bool) else "hybrid"
                          if isinstance(d, str) else d + 1)
    lines = [f"{k}: {str(v).lower() if isinstance(v, bool) else v}  # set"
             for k, v in values.items()]
    (tmp_path / "behavior.yaml").write_text("# behavior\n" + "\n".join(lines) + "\n")
    if reader == "fallback":
        import builtins

        real_import = builtins.__import__

        def no_yaml(name, *a, **k):
            if name == "yaml":
                raise ImportError("no PyYAML here")
            return real_import(name, *a, **k)

        monkeypatch.setattr(builtins, "__import__", no_yaml)
    cfg = tconfig.load_config(str(tmp_path))
    assert dataclasses.asdict(cfg.behavior) == values
    with pytest.raises(ValueError, match="behavior.ttc_nrom"):
        tconfig.load_config(overrides={"behavior": {"ttc_nrom": 7.0}},
                            strict_overrides=True)
