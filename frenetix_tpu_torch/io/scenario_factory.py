"""Synthetic scenario generator: parametric road layouts for testing.

The port's own copy of `frenetix_tpu/io/scenario_factory.py`: straight highways, constant-radius curves and S-curves with configurable
traffic (lead vehicles, oncoming traffic) and a goal region at the end of the
route.  Produces the same `Scenario` objects as the XML reader.
"""
from __future__ import annotations

import numpy as np

from frenetix_tpu_torch.io.commonroad import (
    GoalCondition, Lanelet, Obstacle, PlanningProblem, Scenario, State,
    StopLine, TrafficLight, TrafficSign,
)

__all__ = [
    "make_highway", "make_curve", "make_s_curve", "make_overtake",
    "make_lane_change", "make_traffic_light", "make_stop_sign",
    "make_yield_sign", "make_lane_merge", "make_behavior_overtake",
    "make_crosswalk", "make_intersection_crossing", "make_turn_left",
    "make_turn_right", "make_double_lane_change", "make_double_crossing",
    "make_road_exit", "make_convoy",
]


def _lanelet_from_center(lid, center, half_width, successors=(), **kw):
    d = np.gradient(center, axis=0)
    theta = np.arctan2(d[:, 1], d[:, 0])
    normal = np.stack([-np.sin(theta), np.cos(theta)], axis=1)
    return Lanelet(
        lanelet_id=lid,
        left_vertices=center + half_width * normal,
        right_vertices=center - half_width * normal,
        center_vertices=center.copy(),
        successors=list(successors),
        **kw,
    )


def _traffic(center, speeds, dt, n_steps, start_offsets, lane_offset=0.0):
    """Vehicles following the centerline at constant speed."""
    from frenetix_tpu_torch.geometry.refpath import polyline_pathlength

    s_tab = polyline_pathlength(center)
    d = np.gradient(center, axis=0)
    theta_tab = np.unwrap(np.arctan2(d[:, 1], d[:, 0]))
    normal = np.stack([-np.sin(theta_tab), np.cos(theta_tab)], axis=1)

    obstacles = {}
    for i, (v, s0) in enumerate(zip(speeds, start_offsets)):
        states = []
        for t in range(n_steps + 1):
            s = min(s0 + v * dt * t, s_tab[-1] - 1e-3)
            x = np.interp(s, s_tab, center[:, 0]) + lane_offset * np.interp(
                s, s_tab, normal[:, 0]
            )
            y = np.interp(s, s_tab, center[:, 1]) + lane_offset * np.interp(
                s, s_tab, normal[:, 1]
            )
            th = np.interp(s, s_tab, theta_tab)
            states.append(State(t, np.array([x, y]), float(th), float(v)))
        obstacles[100 + i] = Obstacle(
            obstacle_id=100 + i, obstacle_type="car", role="dynamic",
            length=4.5, width=2.0, initial_state=states[0], trajectory=states[1:],
        )
    return obstacles


def _assemble(scenario_id, centers, lane_width, obstacles, ego_v, goal_frac,
              dt, n_steps):
    lanelets = {}
    for k, c in enumerate(centers):
        succ = [50000 + k + 1] if k + 1 < len(centers) else []
        lanelets[50000 + k] = _lanelet_from_center(50000 + k, c, lane_width / 2, succ)

    route = np.concatenate(centers, axis=0)
    goal_idx = int(goal_frac * (len(route) - 1))
    goal_center = route[goal_idx]
    half = np.array([[5.0, 3.0], [5.0, -3.0], [-5.0, -3.0], [-5.0, 3.0]])
    goal = GoalCondition(
        position_shape=half + goal_center,
        time_interval=(0, n_steps),
        velocity_interval=(0.0, ego_v + 6.0),
    )
    d0 = route[1] - route[0]
    pp = PlanningProblem(
        problem_id=60000,
        initial_state=State(0, route[0] + 0.5 * d0, float(np.arctan2(d0[1], d0[0])),
                            float(ego_v)),
        goals=[goal],
    )
    return Scenario(scenario_id, dt, lanelets, obstacles, {60000: pp})


def make_highway(length=250.0, lanes=1, lane_width=3.6, ego_v=15.0,
                 lead_v=10.0, lead_gap=40.0, dt=0.1, n_steps=200):
    """Straight highway with a slower lead vehicle."""
    n = int(length)
    center = np.stack([np.linspace(0, length, n), np.zeros(n)], axis=1)
    obstacles = _traffic(center, [lead_v], dt, n_steps, [lead_gap])
    return _assemble("SYN_Highway-1", [center], lane_width, obstacles, ego_v,
                     0.9, dt, n_steps)


def make_curve(radius=80.0, arc=np.pi / 2, lane_width=3.6, ego_v=12.0,
               lead_v=8.0, dt=0.1, n_steps=200):
    """Constant-radius left curve with a lead vehicle."""
    n = max(int(radius * arc), 60)
    t = np.linspace(0, arc, n)
    center = np.stack([radius * np.sin(t), radius * (1 - np.cos(t))], axis=1)
    obstacles = _traffic(center, [lead_v], dt, n_steps, [35.0])
    return _assemble("SYN_Curve-1", [center], lane_width, obstacles, ego_v,
                     0.9, dt, n_steps)


def make_s_curve(radius=60.0, lane_width=3.6, ego_v=10.0, dt=0.1, n_steps=250):
    """S-curve (left then right) with two vehicles ahead."""
    n = max(int(radius * np.pi / 2), 60)
    t = np.linspace(0, np.pi / 3, n)
    c1 = np.stack([radius * np.sin(t), radius * (1 - np.cos(t))], axis=1)
    # mirror the curvature for the second half, continuing tangent
    th_end = np.pi / 3
    d = np.array([np.cos(th_end), np.sin(th_end)])
    nvec = np.array([np.sin(th_end), -np.cos(th_end)])
    c2 = (
        c1[-1][None]
        + radius * np.sin(t)[:, None] * d[None]
        + radius * (1 - np.cos(t))[:, None] * nvec[None]
    )
    center = np.concatenate([c1, c2[1:]], axis=0)
    obstacles = _traffic(center, [7.0, 9.0], dt, n_steps, [30.0, 70.0])
    return _assemble("SYN_SCurve-1", [center], lane_width, obstacles, ego_v,
                     0.85, dt, n_steps)


def make_overtake(length=220.0, lane_width=3.6, ego_v=14.0, lead_v=6.0,
                  lead_gap=35.0, dt=0.1, n_steps=200):
    """Two same-direction lanes; a slow lead blocks the right lane — the ego
    must use the lateral sampling range (and the left lane's drivable area)
    to get past it."""
    n = int(length)
    x = np.linspace(0, length, n)
    right_center = np.stack([x, np.zeros(n)], axis=1)
    left_center = np.stack([x, np.full(n, lane_width)], axis=1)

    right = _lanelet_from_center(50000, right_center, lane_width / 2)
    left = _lanelet_from_center(50001, left_center, lane_width / 2)
    right.adj_left = 50001
    right.adj_left_same_direction = True
    left.adj_right = 50000
    left.adj_right_same_direction = True
    lanelets = {50000: right, 50001: left}

    obstacles = _traffic(right_center, [lead_v], dt, n_steps, [lead_gap])

    goal_center = right_center[int(0.92 * (n - 1))]
    half = np.array([[6.0, 3.2], [6.0, -3.2], [-6.0, -3.2], [-6.0, 3.2]])
    goal = GoalCondition(
        position_shape=half + goal_center,
        time_interval=(0, n_steps),
        velocity_interval=(0.0, ego_v + 6.0),
    )
    pp = PlanningProblem(
        problem_id=60000,
        initial_state=State(0, right_center[0] + np.array([1.0, 0.0]), 0.0,
                            float(ego_v)),
        goals=[goal],
    )
    return Scenario("SYN_Overtake-1", dt, lanelets, obstacles, {60000: pp})


# ---------------------------------------------------------------------------
# behavior-planner scenario families: lane change, traffic light, stop/yield
# sign, lane merge, overtake (the behavior planner itself is not ported yet)
# ---------------------------------------------------------------------------


def _straight(length, y=0.0, x0=0.0, step=2.0):
    n = max(int((length) / step) + 1, 2)
    x = np.linspace(x0, x0 + length, n)
    return np.stack([x, np.full(n, y)], axis=1)


def make_lane_change(length=260.0, lane_width=3.6, ego_v=12.0, dt=0.1,
                     n_steps=260, with_traffic=False):
    """Two same-direction lanes; the goal sits on the LEFT lane, so the
    navigation route requires one lane change left — driving the behavior
    FSM through PrepareLaneChangeLeft → LaneChangeLeft → complete."""
    right_center = _straight(length, 0.0)
    left_center = _straight(length, lane_width)
    right = _lanelet_from_center(50000, right_center, lane_width / 2)
    left = _lanelet_from_center(50001, left_center, lane_width / 2)
    right.adj_left, right.adj_left_same_direction = 50001, True
    left.adj_right, left.adj_right_same_direction = 50000, True
    lanelets = {50000: right, 50001: left}

    obstacles = {}
    if with_traffic:
        obstacles = _traffic(left_center, [9.0], dt, n_steps, [60.0])

    goal_center = left_center[int(0.9 * (len(left_center) - 1))]
    half = np.array([[8.0, 1.6], [8.0, -1.6], [-8.0, -1.6], [-8.0, 1.6]])
    goal = GoalCondition(position_shape=half + goal_center,
                         time_interval=(0, n_steps),
                         velocity_interval=(0.0, ego_v + 6.0))
    pp = PlanningProblem(
        problem_id=60000,
        initial_state=State(0, right_center[0] + np.array([2.0, 0.0]), 0.0,
                            float(ego_v)),
        goals=[goal],
    )
    return Scenario("SYN_LaneChange-1", dt, lanelets, obstacles, {60000: pp})


def make_traffic_light(length=160.0, stop_at=90.0, lane_width=3.6, ego_v=10.0,
                       dt=0.1, n_steps=300, red_steps=80, green_steps=400):
    """Single-lane road with a stop line + traffic light at `stop_at`;
    the light is red for `red_steps`, then green.  Drives
    PrepareTrafficLight/TrafficLight (Stopping → WaitingForGreenLight →
    ContinueDriving)."""
    c1 = _straight(stop_at, 0.0)
    c2 = _straight(length - stop_at, 0.0, x0=stop_at)
    l1 = _lanelet_from_center(50000, c1, lane_width / 2, successors=[50001])
    l2 = _lanelet_from_center(50001, c2, lane_width / 2)
    l2.predecessors = [50000]
    light = TrafficLight(
        light_id=70000,
        cycle=[("red", red_steps), ("redYellow", 10), ("green", green_steps)],
        position=np.array([stop_at, lane_width]),
    )
    l1.stop_line = StopLine(
        start=np.array([stop_at, -lane_width / 2]),
        end=np.array([stop_at, lane_width / 2]),
        traffic_light_refs=[70000],
    )
    lanelets = {50000: l1, 50001: l2}

    goal_center = np.array([length - 12.0, 0.0])
    half = np.array([[8.0, 1.6], [8.0, -1.6], [-8.0, -1.6], [-8.0, 1.6]])
    goal = GoalCondition(position_shape=half + goal_center,
                         time_interval=(0, n_steps),
                         velocity_interval=(0.0, ego_v + 6.0))
    pp = PlanningProblem(
        problem_id=60000,
        initial_state=State(0, np.array([2.0, 0.0]), 0.0, float(ego_v)),
        goals=[goal],
    )
    return Scenario("SYN_TrafficLight-1", dt, lanelets, {}, {60000: pp},
                    traffic_lights={70000: light})


def _sign_scenario(sign_element: str, scenario_id: str, length=130.0,
                   stop_at=60.0, lane_width=3.6, ego_v=9.0, dt=0.1,
                   n_steps=300):
    """Single-lane road with a stop line + stop/yield sign at `stop_at`."""
    c1 = _straight(stop_at, 0.0)
    c2 = _straight(length - stop_at, 0.0, x0=stop_at)
    l1 = _lanelet_from_center(50000, c1, lane_width / 2, successors=[50001])
    l2 = _lanelet_from_center(50001, c2, lane_width / 2)
    l2.predecessors = [50000]
    sign = TrafficSign(sign_id=70000, elements=[(sign_element, [])],
                       position=np.array([stop_at, lane_width]))
    l1.stop_line = StopLine(
        start=np.array([stop_at, -lane_width / 2]),
        end=np.array([stop_at, lane_width / 2]),
        traffic_sign_refs=[70000],
    )
    lanelets = {50000: l1, 50001: l2}
    goal_center = np.array([length - 12.0, 0.0])
    half = np.array([[8.0, 1.6], [8.0, -1.6], [-8.0, -1.6], [-8.0, 1.6]])
    goal = GoalCondition(position_shape=half + goal_center,
                         time_interval=(0, n_steps),
                         velocity_interval=(0.0, ego_v + 6.0))
    pp = PlanningProblem(
        problem_id=60000,
        initial_state=State(0, np.array([2.0, 0.0]), 0.0, float(ego_v)),
        goals=[goal],
    )
    return Scenario(scenario_id, dt, lanelets, {}, {60000: pp},
                    traffic_signs={70000: sign})


def make_stop_sign(**kw):
    """Stop sign: the FSM must reach WaitingForStopYieldSignClearance (full
    stop ≥ 1 s) before ContinueDriving."""
    return _sign_scenario("206", "SYN_StopSign-1", **kw)


def make_yield_sign(**kw):
    """Yield sign: passable without stopping when clear
    (StopYieldSignClear)."""
    return _sign_scenario("205", "SYN_YieldSign-1", **kw)


def make_lane_merge(length=220.0, merge_at=120.0, lane_width=3.6, ego_v=11.0,
                    dt=0.1, n_steps=250):
    """Two parallel approach lanes merging into one: the merged lanelet has
    two predecessors with a shared end point (static_route._detect_lane_merges
    criterion, reference path_planner.py:586-610)."""
    cm = _straight(length - merge_at, 0.0, x0=merge_at)
    ca = _straight(merge_at, 0.0)
    # merging lane bends into the main lane over its final 40 m
    n = max(int(merge_at / 2.0) + 1, 2)
    x = np.linspace(0.0, merge_at, n)
    y = np.where(x < merge_at - 40.0, lane_width,
                 lane_width * (merge_at - x) / 40.0)
    cb = np.stack([x, y], axis=1)
    main_in = _lanelet_from_center(50000, ca, lane_width / 2, successors=[50002])
    ramp = _lanelet_from_center(50001, cb, lane_width / 2, successors=[50002])
    merged = _lanelet_from_center(50002, cm, lane_width / 2)
    merged.predecessors = [50000, 50001]
    lanelets = {50000: main_in, 50001: ramp, 50002: merged}

    goal_center = cm[int(0.85 * (len(cm) - 1))]
    half = np.array([[8.0, 1.6], [8.0, -1.6], [-8.0, -1.6], [-8.0, 1.6]])
    goal = GoalCondition(position_shape=half + goal_center,
                         time_interval=(0, n_steps),
                         velocity_interval=(0.0, ego_v + 6.0))
    pp = PlanningProblem(
        problem_id=60000,
        initial_state=State(0, ca[0] + np.array([2.0, 0.0]), 0.0, float(ego_v)),
        goals=[goal],
    )
    return Scenario("SYN_LaneMerge-1", dt, lanelets, {}, {60000: pp})


def make_behavior_overtake(length=300.0, lane_width=3.6, ego_v=13.0,
                           lead_v=4.0, lead_gap=45.0, dt=0.1, n_steps=300):
    """Two same-direction lanes with a slow lead on the ego lane and the goal
    on the SAME (right) lane — forcing a behavior-level overtake
    (PrepareOvertake → lane change left → Overtake → FinishOvertake → lane
    change right), not just lateral sampling."""
    right_center = _straight(length, 0.0)
    left_center = _straight(length, lane_width)
    right = _lanelet_from_center(50000, right_center, lane_width / 2)
    left = _lanelet_from_center(50001, left_center, lane_width / 2)
    right.adj_left, right.adj_left_same_direction = 50001, True
    left.adj_right, left.adj_right_same_direction = 50000, True
    lanelets = {50000: right, 50001: left}

    obstacles = _traffic(right_center, [lead_v], dt, n_steps, [lead_gap])

    goal_center = right_center[int(0.93 * (len(right_center) - 1))]
    half = np.array([[8.0, 1.6], [8.0, -1.6], [-8.0, -1.6], [-8.0, 1.6]])
    goal = GoalCondition(position_shape=half + goal_center,
                         time_interval=(0, n_steps),
                         velocity_interval=(0.0, ego_v + 6.0))
    pp = PlanningProblem(
        problem_id=60000,
        initial_state=State(0, right_center[0] + np.array([2.0, 0.0]), 0.0,
                            float(ego_v)),
        goals=[goal],
    )
    return Scenario("SYN_BehaviorOvertake-1", dt, lanelets, obstacles,
                    {60000: pp})


def make_intersection_crossing(arm=60.0, box=10.0, lane_width=3.6, ego_v=10.0,
                               cross_v=8.0, cross_delay=30.0, dt=0.1,
                               n_steps=250):
    """Perpendicular crossing with a CommonRoad intersection element: the ego
    drives +x through the junction; a crossing vehicle on the +y road passes
    `cross_delay` meters behind schedule — exercising the lanelet
    conflict-area ET/PET metrics (reference metrics.py:613-727)."""
    from frenetix_tpu_torch.io.commonroad import Intersection, IntersectionIncoming

    # x-road: approach (A1) → crossing (A2) → exit (A3)
    a1 = _straight(arm - box, 0.0, x0=-arm)
    a2 = _straight(2 * box, 0.0, x0=-box)
    a3 = _straight(arm - box, 0.0, x0=box)
    # y-road (crossing traffic, +y direction)
    def _vert(length, x=0.0, y0=0.0, step=2.0):
        n = max(int(length / step) + 1, 2)
        y = np.linspace(y0, y0 + length, n)
        return np.stack([np.full(n, x), y], axis=1)

    b1 = _vert(arm - box, y0=-arm)
    b2 = _vert(2 * box, y0=-box)
    b3 = _vert(arm - box, y0=box)

    lanelets = {}
    for lid, (center, succ) in {
        50000: (a1, [50001]), 50001: (a2, [50002]), 50002: (a3, []),
        50010: (b1, [50011]), 50011: (b2, [50012]), 50012: (b3, []),
    }.items():
        lanelets[lid] = _lanelet_from_center(lid, center, lane_width / 2, succ)
    lanelets[50001].predecessors = [50000]
    lanelets[50002].predecessors = [50001]
    lanelets[50011].predecessors = [50010]
    lanelets[50012].predecessors = [50011]

    intersection = Intersection(70000, incomings=[
        IntersectionIncoming(1, incoming_lanelets=[50000],
                             successors_straight=[50001]),
        IntersectionIncoming(2, incoming_lanelets=[50010],
                             successors_straight=[50011]),
    ])

    # crossing vehicle on the y-road, starting cross_delay behind its stop line
    obstacles = _traffic(np.concatenate([b1, b2[1:], b3[1:]]), [cross_v], dt,
                         n_steps, [arm - box - cross_delay])

    goal_center = np.array([arm - 12.0, 0.0])
    half = np.array([[8.0, 1.6], [8.0, -1.6], [-8.0, -1.6], [-8.0, 1.6]])
    goal = GoalCondition(position_shape=half + goal_center,
                         time_interval=(0, n_steps),
                         velocity_interval=(0.0, ego_v + 6.0))
    pp = PlanningProblem(
        problem_id=60000,
        initial_state=State(0, np.array([-arm + 2.0, 0.0]), 0.0, float(ego_v)),
        goals=[goal],
    )
    return Scenario("SYN_Crossing-1", dt, lanelets, obstacles, {60000: pp},
                    intersections=[intersection])


def make_road_exit(main_len=100.0, ramp_len=90.0, lane_width=3.6, ego_v=13.0,
                   radius=260.0, dt=0.1, n_steps=220, through_v=None):
    """Highway off-ramp: the route forks off the through road at x=main_len
    onto a gently curving exit ramp (κ = 1/radius ≈ 0.004, far below the
    turn-detection threshold).  Exercises the (Prepare)RoadExit static goals
    and the RoadExit FSM situation.  `through_v` adds a car continuing on
    the through lane (the ego must not treat it as crossing traffic)."""
    m1 = _straight(main_len)                       # approach, x ∈ [0, 100]
    m2 = _straight(150.0, x0=main_len)             # through road continues
    # ramp: arc of radius `radius` curving right from (main_len, 0)
    th = np.linspace(0.0, ramp_len / radius, 40)
    ramp = np.stack([main_len + radius * np.sin(th),
                     radius * (np.cos(th) - 1.0)], axis=1)

    lanelets = {
        50000: _lanelet_from_center(50000, m1, lane_width / 2, [50001, 50010]),
        50001: _lanelet_from_center(50001, m2, lane_width / 2, []),
        50010: _lanelet_from_center(50010, ramp, lane_width / 2, []),
    }
    lanelets[50001].predecessors = [50000]
    lanelets[50010].predecessors = [50000]

    obstacles = {}
    if through_v:
        obstacles = _traffic(np.concatenate([m1, m2[1:]]), [through_v], dt,
                             n_steps, [main_len - 20.0])

    goal_center = ramp[-1] - 10.0 * (ramp[-1] - ramp[-2]) / np.linalg.norm(
        ramp[-1] - ramp[-2])
    half = np.array([[8.0, 3.0], [8.0, -3.0], [-8.0, -3.0], [-8.0, 3.0]])
    goal = GoalCondition(position_shape=half + goal_center,
                         time_interval=(0, n_steps),
                         velocity_interval=(0.0, ego_v + 6.0))
    pp = PlanningProblem(
        problem_id=60000,
        initial_state=State(0, np.array([2.0, 0.0]), 0.0, float(ego_v)),
        goals=[goal],
    )
    return Scenario("SYN_RoadExit-1", dt, lanelets, obstacles, {60000: pp})


def make_double_crossing(arm=50.0, box=10.0, spacing=70.0, lane_width=3.6,
                         ego_v=10.0, cross_v=8.0, cross_delay=38.0,
                         far_traffic="crossing", dt=0.1, n_steps=320):
    """TWO perpendicular crossings in sequence along +x with traffic only at
    the FAR junction.  Discriminates per-junction conflict zones from a
    single merged mega-zone: the near junction is empty the whole time, so
    the ego must sail through it without yielding — a clearance model that
    aggregates both junctions' lanelets would propagate the far road's
    traffic into the near junction's gate and stall the ego at the first,
    empty junction entry.

    `far_traffic`: "crossing" — a car on the far y-road, `cross_delay`
    metres before its junction entry, crossing at `cross_v` (clears long
    before the ego arrives); "standing" — a car standing in the middle of
    the far junction (for clearance unit probes; note the ego's own
    standing-lead velocity logic also reacts to it on approach)."""
    from frenetix_tpu_torch.io.commonroad import Intersection, IntersectionIncoming

    def _vert(length, x=0.0, y0=0.0, step=2.0):
        n = max(int(length / step) + 1, 2)
        y = np.linspace(y0, y0 + length, n)
        return np.stack([np.full(n, x), y], axis=1)

    # x-road: approach → junction 1 → middle → junction 2 → exit
    a1 = _straight(arm - box, 0.0, x0=-arm)
    a2 = _straight(2 * box, 0.0, x0=-box)
    a3 = _straight(spacing - 2 * box, 0.0, x0=box)
    a4 = _straight(2 * box, 0.0, x0=spacing - box)
    a5 = _straight(arm - box, 0.0, x0=spacing + box)
    # y-roads at x = 0 (empty) and x = spacing (standing car)
    b1, b2, b3 = (_vert(arm - box, 0.0, -arm), _vert(2 * box, 0.0, -box),
                  _vert(arm - box, 0.0, box))
    c1 = _vert(arm - box, spacing, -arm)
    c2 = _vert(2 * box, spacing, -box)
    c3 = _vert(arm - box, spacing, box)

    lanelets = {}
    for lid, (center, succ) in {
        50000: (a1, [50001]), 50001: (a2, [50002]), 50002: (a3, [50003]),
        50003: (a4, [50004]), 50004: (a5, []),
        50010: (b1, [50011]), 50011: (b2, [50012]), 50012: (b3, []),
        50020: (c1, [50021]), 50021: (c2, [50022]), 50022: (c3, []),
    }.items():
        lanelets[lid] = _lanelet_from_center(lid, center, lane_width / 2, succ)
    for lid in (50001, 50002, 50003, 50004, 50011, 50012, 50021, 50022):
        lanelets[lid].predecessors = [lid - 1]

    intersections = [
        Intersection(70000, incomings=[
            IntersectionIncoming(1, incoming_lanelets=[50000],
                                 successors_straight=[50001]),
            IntersectionIncoming(2, incoming_lanelets=[50010],
                                 successors_straight=[50011]),
        ]),
        Intersection(70001, incomings=[
            IntersectionIncoming(3, incoming_lanelets=[50002],
                                 successors_straight=[50003]),
            IntersectionIncoming(4, incoming_lanelets=[50020],
                                 successors_straight=[50021]),
        ]),
    ]

    if far_traffic == "standing":
        states = [State(t, np.array([spacing, 0.0]), np.pi / 2, 0.0)
                  for t in range(n_steps + 1)]
        obstacles = {100: Obstacle(
            obstacle_id=100, obstacle_type="car", role="dynamic", length=4.5,
            width=2.0, initial_state=states[0], trajectory=states[1:],
        )}
    else:
        far_path = np.concatenate([c1, c2[1:], c3[1:]])
        obstacles = _traffic(far_path, [cross_v], dt, n_steps,
                             [arm - box - cross_delay])

    goal_center = np.array([spacing + arm - 12.0, 0.0])
    half = np.array([[8.0, 1.6], [8.0, -1.6], [-8.0, -1.6], [-8.0, 1.6]])
    goal = GoalCondition(position_shape=half + goal_center,
                         time_interval=(0, n_steps),
                         velocity_interval=(0.0, ego_v + 6.0))
    pp = PlanningProblem(
        problem_id=60000,
        initial_state=State(0, np.array([-arm + 2.0, 0.0]), 0.0, float(ego_v)),
        goals=[goal],
    )
    return Scenario("SYN_DoubleCrossing-1", dt, lanelets, obstacles,
                    {60000: pp}, intersections=intersections)


def make_turn_left(arm=50.0, lane_width=3.6, ego_v=9.0, oncoming_v=8.0,
                   oncoming_start=30.0, dt=0.1, n_steps=300):
    """T-junction left turn across oncoming traffic: the ego's route bends
    through a quarter-circle street corner (radius ≈ 11.8 m → curvature
    0.085, above the 0.03 turn-detection threshold hinted at in the
    reference's path_planner.py:663) while an oncoming car approaches on
    the opposite lane.  Exercises TurnLeft static goals and the
    lane-conflict turn clearance."""
    from frenetix_tpu_torch.io.commonroad import Intersection, IntersectionIncoming

    half = lane_width / 2
    r = 10.0 + half  # corner radius of the ego-lane centerline

    # ego approach: eastbound lane (centre y = -half), x ∈ [-arm-10, -10]
    a1 = _straight(arm, y=-half, x0=-arm - 10.0)
    # left-turn arc: quarter circle about (-10, 10) from (-10,-half) to
    # (half, 10), ending northbound
    th = np.linspace(-np.pi / 2, 0.0, 20)
    arc = np.stack([-10.0 + r * np.cos(th), 10.0 + r * np.sin(th)], axis=1)
    # exit: northbound lane (centre x = +half), y ∈ [10, 10+arm]
    a3 = np.stack([np.full(26, half), np.linspace(10.0, 10.0 + arm, 26)], axis=1)

    # oncoming road: westbound lane (centre y = +half), split into
    # approach → junction → exit so the junction piece is an intersection
    # successor
    b1 = np.stack([np.linspace(10.0 + arm, 10.0, 26), np.full(26, half)], axis=1)
    b2 = np.stack([np.linspace(10.0, -10.0, 11), np.full(11, half)], axis=1)
    b3 = np.stack([np.linspace(-10.0, -10.0 - arm, 26), np.full(26, half)], axis=1)

    lanelets = {}
    for lid, (center, succ) in {
        50000: (a1, [50001]), 50001: (arc, [50002]), 50002: (a3, []),
        50010: (b1, [50011]), 50011: (b2, [50012]), 50012: (b3, []),
    }.items():
        lanelets[lid] = _lanelet_from_center(lid, center, half, succ)
    lanelets[50001].predecessors = [50000]
    lanelets[50002].predecessors = [50001]
    lanelets[50011].predecessors = [50010]
    lanelets[50012].predecessors = [50011]

    intersection = Intersection(70000, incomings=[
        IntersectionIncoming(1, incoming_lanelets=[50000],
                             successors_left=[50001]),
        IntersectionIncoming(2, incoming_lanelets=[50010],
                             successors_straight=[50011]),
    ])

    # oncoming car westbound, `oncoming_start` metres into its road
    oncoming_center = np.concatenate([b1, b2[1:], b3[1:]])
    obstacles = _traffic(oncoming_center, [oncoming_v], dt, n_steps,
                         [oncoming_start])

    goal_center = np.array([half, 10.0 + arm - 12.0])
    box = np.array([[1.6, 8.0], [1.6, -8.0], [-1.6, -8.0], [-1.6, 8.0]])
    goal = GoalCondition(position_shape=box + goal_center,
                         time_interval=(0, n_steps),
                         velocity_interval=(0.0, ego_v + 6.0))
    pp = PlanningProblem(
        problem_id=60000,
        initial_state=State(0, np.array([-arm - 8.0, -half]), 0.0, float(ego_v)),
        goals=[goal],
    )
    return Scenario("SYN_TurnLeft-1", dt, lanelets, obstacles, {60000: pp},
                    intersections=[intersection])


def make_double_lane_change(length=300.0, lane_width=3.6, ego_v=12.0, dt=0.1,
                            n_steps=300):
    """Three same-direction lanes; the goal sits two lanes LEFT of the ego's
    start lane, so the navigation route chains two adjacency edges
    (50000→50001→50002) and the behavior FSM must execute two sequential
    lane changes (nav_lane_changes_left = 2).  Also exercises chained
    mid-overlap blends in the route centerline."""
    lanes = {}
    for k in range(3):
        c = _straight(length, k * lane_width)
        lanes[50000 + k] = _lanelet_from_center(50000 + k, c, lane_width / 2)
    lanes[50000].adj_left, lanes[50000].adj_left_same_direction = 50001, True
    lanes[50001].adj_right, lanes[50001].adj_right_same_direction = 50000, True
    lanes[50001].adj_left, lanes[50001].adj_left_same_direction = 50002, True
    lanes[50002].adj_right, lanes[50002].adj_right_same_direction = 50001, True

    goal_center = np.array([0.9 * length, 2 * lane_width])
    box = np.array([[8.0, 1.6], [8.0, -1.6], [-8.0, -1.6], [-8.0, 1.6]])
    goal = GoalCondition(position_shape=box + goal_center,
                         time_interval=(0, n_steps),
                         velocity_interval=(0.0, ego_v + 6.0))
    pp = PlanningProblem(
        problem_id=60000,
        initial_state=State(0, np.array([2.0, 0.0]), 0.0, float(ego_v)),
        goals=[goal],
    )
    return Scenario("SYN_DoubleLC-1", dt, lanes, {}, {60000: pp})


def make_turn_right(arm=50.0, lane_width=3.6, ego_v=10.0, through_v=8.0,
                    through_start=30.0, dt=0.1, n_steps=300):
    """T-junction right turn merging into through traffic: the ego's route
    bends right (quarter circle, curvature ≈ −0.12) into a southbound road
    on which a through car approaches the junction from the north.  The
    through car's route passes the end of the ego's turn arc, so the
    lane-conflict clearance must hold the ego at the junction entry until
    it has passed, then the ego merges BEHIND it (TTC following).  Mirror
    of `make_turn_left` for the TurnRight states."""
    from frenetix_tpu_torch.io.commonroad import Intersection, IntersectionIncoming

    half = lane_width / 2
    r = 10.0 - half  # corner radius of the ego-lane centerline (right turn)

    # ego approach: eastbound lane (centre y = -half), x ∈ [-arm-10, -10]
    a1 = _straight(arm, y=-half, x0=-arm - 10.0)
    # right-turn arc: quarter circle about (-10, -10) from (-10, -half)
    # to (-half, -10), ending southbound
    th = np.linspace(np.pi / 2, 0.0, 20)
    arc = np.stack([-10.0 + r * np.cos(th), -10.0 + r * np.sin(th)], axis=1)
    # shared exit: southbound lane (centre x = -half), y ∈ [-10, -10-arm]
    a3 = np.stack([np.full(26, -half), np.linspace(-10.0, -10.0 - arm, 26)],
                  axis=1)

    # through road from the north: approach → junction → the SAME exit
    # lanelet the ego's arc feeds (a true merge)
    b1 = np.stack([np.full(26, -half), np.linspace(10.0 + arm, 10.0, 26)], axis=1)
    b2 = np.stack([np.full(11, -half), np.linspace(10.0, -10.0, 11)], axis=1)

    lanelets = {}
    for lid, (center, succ) in {
        50000: (a1, [50001]), 50001: (arc, [50002]), 50002: (a3, []),
        50010: (b1, [50011]), 50011: (b2, [50002]),
    }.items():
        lanelets[lid] = _lanelet_from_center(lid, center, half, succ)
    lanelets[50001].predecessors = [50000]
    lanelets[50002].predecessors = [50001, 50011]
    lanelets[50011].predecessors = [50010]

    intersection = Intersection(70000, incomings=[
        IntersectionIncoming(1, incoming_lanelets=[50000],
                             successors_right=[50001]),
        IntersectionIncoming(2, incoming_lanelets=[50010],
                             successors_straight=[50011]),
    ])

    # through car southbound, `through_start` metres into its road
    through_center = np.concatenate([b1, b2[1:], a3[1:]])
    obstacles = _traffic(through_center, [through_v], dt, n_steps,
                         [through_start])

    goal_center = np.array([-half, -10.0 - arm + 12.0])
    box = np.array([[1.6, 8.0], [1.6, -8.0], [-1.6, -8.0], [-1.6, 8.0]])
    goal = GoalCondition(position_shape=box + goal_center,
                         time_interval=(0, n_steps),
                         velocity_interval=(0.0, ego_v + 6.0))
    pp = PlanningProblem(
        problem_id=60000,
        initial_state=State(0, np.array([-arm - 8.0, -half]), 0.0, float(ego_v)),
        goals=[goal],
    )
    return Scenario("SYN_TurnRight-1", dt, lanelets, obstacles, {60000: pp},
                    intersections=[intersection])


def make_crosswalk(length=130.0, cross_at=60.0, lane_width=3.6, ego_v=9.0,
                   ped_v=2.0, ped_start=-10.0, dt=0.1, n_steps=300):
    """Straight road with a crosswalk lanelet at `cross_at` and a pedestrian
    walking across: the FSM must yield (Crosswalk states, pedestrians-only
    clearance) until the pedestrian leaves the conflict zone."""
    c1 = _straight(cross_at, 0.0)
    c2 = _straight(length - cross_at, 0.0, x0=cross_at)
    l1 = _lanelet_from_center(50000, c1, lane_width / 2, successors=[50001])
    l2 = _lanelet_from_center(50001, c2, lane_width / 2)
    l2.predecessors = [50000]
    # crosswalk lanelet: 3 m wide strip crossing the road at x = cross_at
    n = 9
    y = np.linspace(-6.0, 6.0, n)
    cw_center = np.stack([np.full(n, cross_at), y], axis=1)
    cw = _lanelet_from_center(50050, cw_center, 1.5)
    cw.lanelet_type = "crosswalk"
    lanelets = {50000: l1, 50001: l2, 50050: cw}

    # pedestrian crossing at constant speed
    states = []
    for t in range(n_steps + 1):
        yp = ped_start + ped_v * dt * t
        states.append(State(t, np.array([cross_at, yp]), np.pi / 2, float(ped_v)))
    ped = Obstacle(
        obstacle_id=200, obstacle_type="pedestrian", role="dynamic",
        length=0.5, width=0.5, initial_state=states[0], trajectory=states[1:],
    )

    goal_center = np.array([length - 12.0, 0.0])
    half = np.array([[8.0, 1.6], [8.0, -1.6], [-8.0, -1.6], [-8.0, 1.6]])
    goal = GoalCondition(position_shape=half + goal_center,
                         time_interval=(0, n_steps),
                         velocity_interval=(0.0, ego_v + 6.0))
    pp = PlanningProblem(
        problem_id=60000,
        initial_state=State(0, np.array([2.0, 0.0]), 0.0, float(ego_v)),
        goals=[goal],
    )
    return Scenario("SYN_Crosswalk-1", dt, lanelets, {200: ped}, {60000: pp})


def make_convoy(n_vehicles=7, length=650.0, lane_width=3.6, ego_v=10.0,
                vehicle_v=10.0, gap=30.0, goal_frac=0.38, dt=0.1,
                n_steps=250):
    """Single-lane platoon: `n_vehicles` constant-speed cars ahead of the
    ego.  In multiagent mode every vehicle becomes a planning agent
    (A = n_vehicles + 1) — the scale workload for the batched/device
    simulation paths.  The road is long enough that no recorded trajectory
    clamps at its end (a clamped leader becomes a parked wall) and the ego
    goal is reachable within the horizon."""
    n = int(length)
    center = np.stack([np.linspace(0, length, n), np.zeros(n)], axis=1)
    speeds = [vehicle_v] * n_vehicles
    offsets = [gap * (i + 1) for i in range(n_vehicles)]
    obstacles = _traffic(center, speeds, dt, n_steps, offsets)
    return _assemble("SYN_Convoy-1", [center], lane_width, obstacles, ego_v,
                     goal_frac, dt, n_steps)
