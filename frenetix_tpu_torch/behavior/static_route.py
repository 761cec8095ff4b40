"""The port's own copy of `frenetix_tpu/behavior/static_route.py` (NumPy only).

Static route plan: intermediate behavior goals along the navigation route.

Port of the reference's `RoutePlan` (behavior_planner/utils/path_planner.py:
290-880): walk the route's lanelets, detect traffic lights / stop & yield
signs (via stop lines), lane merges (multi-predecessor lanelets) and
intersections, wrap each in a (Prepare*, *) goal pair whose lengths scale with
the local speed limit, then straighten overlapping goals by priority and fill
the gaps with StaticDefault so the plan tiles [0, route_length] exactly.

The resulting plan drives the FSM's static behavior layer
(`LogicBehaviorStatic`, FSM_logic_modules.py:58-87): the goal containing the
ego's current s-position is the `current_static_goal`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from frenetix_tpu_torch.io.commonroad import Scenario, speed_limit_for_lanelets

__all__ = ["StaticGoal", "GOAL_PRIORITY", "build_static_route_plan"]


# StaticGoalPrio (path_planner.py:676-706): larger wins overlaps.
GOAL_PRIORITY = {
    "TrafficLight": 95, "StopSign": 90, "YieldSign": 85, "Crosswalk": 80,
    "PrepareTrafficLight": 75, "PrepareStopSign": 70, "PrepareYieldSign": 65,
    "PrepareCrosswalk": 60,
    "TurnRight": 46, "TurnLeft": 45, "PrepareTurnRight": 41, "PrepareTurnLeft": 40,
    "LaneMerge": 35, "RoadExit": 30, "PrepareLaneMerge": 25, "PrepareRoadExit": 20,
    "Intersection": 11, "PrepareIntersection": 10,
    "StaticDefault": 1,
}

# default speed by street setting when no sign applies (path_planner.py:348-357)
_DEFAULT_SPEED = {"Highway": 130 / 3.6, "Country": 100 / 3.6, "Urban": 50 / 3.6}


@dataclass
class StaticGoal:
    goal_type: str
    start_s: float
    end_s: float
    stop_point_s: Optional[float] = None
    stop_point_xy: Optional[np.ndarray] = None
    goal_object: object = None        # TrafficLight / TrafficSign
    goal_lanelet_id: Optional[int] = None

    def contains(self, s: float) -> bool:
        return self.start_s <= s < self.end_s

    @property
    def priority(self) -> int:
        return GOAL_PRIORITY.get(self.goal_type, 1)


def _detect_stop_line_goals(scenario: Scenario, route_ids, frame):
    """Traffic lights + stop/yield signs attached to route stop lines
    (path_planner.py:499-584)."""
    goals = []
    for lid in route_ids:
        ll = scenario.lanelets.get(lid)
        if ll is None or ll.stop_line is None:
            continue
        stop_xy = ll.stop_line.center
        stop_s, _ = frame.project(stop_xy)
        for sign_id in ll.stop_line.traffic_sign_refs:
            sign = scenario.traffic_signs.get(sign_id)
            if sign is None:
                continue
            pos_s = frame.project(sign.position)[0] if sign.position is not None else stop_s
            gtype = "StopSign" if sign.is_stop else ("YieldSign" if sign.is_yield else None)
            if gtype is None:
                continue
            goals.append(dict(type=gtype, position_s=pos_s, stop_position_s=stop_s,
                              stop_position_xy=stop_xy, obj=sign, lanelet_id=lid))
        for light_id in ll.stop_line.traffic_light_refs:
            light = scenario.traffic_lights.get(light_id)
            if light is None or not light.active:
                continue
            pos_s = frame.project(light.position)[0] if light.position is not None else stop_s
            goals.append(dict(type="TrafficLight", position_s=pos_s, stop_position_s=stop_s,
                              stop_position_xy=stop_xy, obj=light, lanelet_id=lid))
    return goals


def _detect_crosswalks(scenario: Scenario, route_ids, frame):
    """Crosswalk lanelets crossing the route → Crosswalk goals.

    The reference's RoutePlan handles Crosswalk goals in its goal-building
    switch (path_planner.py:363) but never creates them (its detector is a
    TODO); here lanelets typed 'crosswalk' whose center projects onto the
    route become goals with the stop line ~2 m before the crossing."""
    goals = []
    route_set = set(route_ids)
    for ll in scenario.lanelets.values():
        if "crosswalk" not in (ll.lanelet_type or "").lower():
            continue
        center = ll.center_vertices[len(ll.center_vertices) // 2]
        s, d = frame.project(center)
        if not (0.0 < s < frame.length) or abs(d) > 6.0:
            continue
        # crosswalk must actually overlap a route lanelet
        if not any(
            scenario.lanelets[r].contains_point(center) for r in route_set
            if r in scenario.lanelets
        ):
            continue
        half = max(
            float(np.linalg.norm(ll.left_vertices[0] - ll.right_vertices[0])),
            2.0,
        ) / 2.0
        goals.append(dict(
            type="Crosswalk", position_s=s + half,
            stop_position_s=max(s - half - 2.0, 0.001),
            stop_position_xy=frame.to_cartesian(max(s - half - 2.0, 0.001)),
            obj=ll, lanelet_id=ll.lanelet_id,
        ))
    return goals


def _detect_lane_merges(scenario: Scenario, route_ids, frame):
    """Lanelets with ≥2 predecessors sharing an end point + similar
    orientation (path_planner.py:586-610)."""
    merges = []
    for lid in route_ids:
        ll = scenario.lanelets.get(lid)
        if ll is None or len(ll.predecessors) < 2:
            continue
        p1 = scenario.lanelets.get(ll.predecessors[0])
        p2 = scenario.lanelets.get(ll.predecessors[1])
        if p1 is None or p2 is None:
            continue
        if not np.allclose(p1.center_vertices[-1], p2.center_vertices[-1]):
            continue
        o1 = p1.center_vertices[1] - p1.center_vertices[0]
        o2 = p2.center_vertices[1] - p2.center_vertices[0]
        o1 = o1 / max(np.linalg.norm(o1), 1e-9)
        o2 = o2 / max(np.linalg.norm(o2), 1e-9)
        if not np.allclose(o1, o2, atol=0.1):
            continue
        merge_s, _ = frame.project(ll.center_vertices[0])
        merges.append(dict(type="LaneMerge", position_s=merge_s, lanelet_id=lid))
    return merges


def _detect_road_exits(scenario: Scenario, route_ids, frame):
    """Route lanelets that take a fork OFF the through road (off-ramps): the
    predecessor has ≥2 successors and the route's choice diverges from the
    through branch — the branch whose endpoint stays on the predecessor's
    extension line.  The inverse of `_detect_lane_merges`; the reference's
    PathPlanner derives RoadExit goals from its route lane changes
    (path_planner.py:586-610 neighborhood).  Junction-interior forks are
    intersection/turn goals, not road exits."""
    exits = []
    inter_lls = intersection_successor_ids(scenario)
    for lid in route_ids:
        ll = scenario.lanelets.get(lid)
        if ll is None or lid in inter_lls:
            continue
        for pid in ll.predecessors:
            p = scenario.lanelets.get(pid)
            if p is None or len(p.successors) < 2 or len(p.center_vertices) < 2:
                continue
            p_end = p.center_vertices[-1]
            p_dir = p_end - p.center_vertices[-2]
            p_dir = p_dir / max(np.linalg.norm(p_dir), 1e-9)
            # measure every branch at the SAME arc length (capped at the
            # shortest branch / 40 m) — raw endpoint offsets mis-rank
            # branches of unequal length (a long curving through-road would
            # read as the exit)
            sibs = {}
            for sid in p.successors:
                s_ll = scenario.lanelets.get(sid)
                if s_ll is not None and len(s_ll.center_vertices) >= 2:
                    sibs[sid] = s_ll.center_vertices
            if len(sibs) < 2 or lid not in sibs:
                continue

            def _arclen(v):
                return float(np.linalg.norm(np.diff(v, axis=0), axis=1).sum())

            probe = min(min(_arclen(v) for v in sibs.values()), 40.0)
            lateral = {}
            for sid, verts in sibs.items():
                seg = np.linalg.norm(np.diff(verts, axis=0), axis=1)
                s_tab = np.concatenate([[0.0], np.cumsum(seg)])
                q = np.array([np.interp(probe, s_tab, verts[:, 0]),
                              np.interp(probe, s_tab, verts[:, 1])])
                rel = q - p_end
                lateral[sid] = abs(float(p_dir[0] * rel[1] - p_dir[1] * rel[0]))
            if lateral[lid] > min(lateral.values()) + 1.0:
                exit_s, _ = frame.project(ll.center_vertices[0])
                exits.append(dict(type="RoadExit", position_s=exit_s,
                                  lanelet_id=lid))
                break
    return exits


def intersection_successor_ids(scenario: Scenario) -> set:
    """All lanelet ids that are successors of an intersection incoming —
    the junction-interior lanelets.  Single source of truth shared by the
    turn/intersection goal detectors here and the FSM's lane-conflict
    clearance (fsm.EgoFSM._conflict_clear)."""
    ids: set = set()
    for inter in scenario.intersections:
        for inc in inter.incomings:
            ids.update(inc.successors_left + inc.successors_right
                       + inc.successors_straight)
    return ids


def _detect_intersections(scenario: Scenario, route_ids, frame):
    """Route lanelets that are successors of an intersection incoming
    (path_planner.py:612-656)."""
    found = []
    inter_lls = intersection_successor_ids(scenario)
    for lid in route_ids:
        if lid not in inter_lls:
            continue
        ll = scenario.lanelets.get(lid)
        if ll is None:
            continue
        start_s = frame.project(ll.center_vertices[0])[0]
        end_s = frame.project(ll.center_vertices[-1])[0]
        if end_s <= start_s:
            end_s = min(start_s + 15.0, frame.length)
        found.append(dict(type="Intersection", start_s=start_s,
                          end_s=end_s, lanelet_id=lid,
                          stop_position_xy=frame.to_cartesian(start_s)))
    return found


def _junction_s_intervals(scenario: Scenario, route_ids, frame,
                          margin: float = 10.0):
    """s-intervals of route lanelets that belong to a junction: successors of
    an intersection incoming, or — on maps without intersection elements —
    lanelets with fork/merge topology (predecessor with ≥2 successors, or ≥2
    predecessors).  A plain curved road (single successor chain) yields
    none."""
    inter_lls = intersection_successor_ids(scenario)
    intervals = []
    for lid in route_ids:
        ll = scenario.lanelets.get(lid)
        if ll is None or len(ll.center_vertices) < 2:
            continue
        if scenario.intersections:
            is_junction = lid in inter_lls
        else:
            preds = [scenario.lanelets.get(p) for p in ll.predecessors]
            is_junction = len(ll.predecessors) >= 2 or any(
                p is not None and len(p.successors) >= 2 for p in preds
            )
        if not is_junction:
            continue
        s0 = frame.project(ll.center_vertices[0])[0]
        s1 = frame.project(ll.center_vertices[-1])[0]
        intervals.append((min(s0, s1) - margin, max(s0, s1) + margin))
    return intervals


# np.trapezoid (numpy ≥ 2) with the numpy-1.x spelling as fallback
_trapezoid = getattr(np, "trapezoid", None) or np.trapz


def _detect_turns(scenario: Scenario, route_ids, frame,
                  kappa_threshold: float = 0.03,
                  min_heading_change: float = 0.5):
    """Sustained high-curvature regions of the reference path inside a
    junction → TurnLeft / TurnRight goals.  The reference leaves turn
    detection as a TODO (path_planner.py:320) but hints at the curvature
    heuristic: 'maybe look at the reference path curvature: if greater than
    0.03 it might be a turn' (path_planner.py:663-664).  Two additional
    gates keep it from over-firing:

      - a total heading change of ≥ `min_heading_change` rad separates
        street-corner turns from the two short counter-signed curvature
        lobes of a lane change (the '--_^^_--' signature :663),
      - the region must overlap a junction lanelet of the route
        (`_junction_s_intervals`) — otherwise any sustained r < ~33 m road
        segment (ramps, switchbacks, roundabout arcs) would become a turn
        goal with a spurious yield line at its entry.
    """
    xy, s = frame.xy, frame.s
    if len(xy) < 5:
        return []
    junctions = _junction_s_intervals(scenario, route_ids, frame)
    if not junctions:
        return []
    dx, dy = np.gradient(xy[:, 0], s), np.gradient(xy[:, 1], s)
    ddx, ddy = np.gradient(dx, s), np.gradient(dy, s)
    denom = np.maximum((dx * dx + dy * dy) ** 1.5, 1e-12)
    kappa = (dx * ddy - dy * ddx) / denom
    hot = np.abs(kappa) > kappa_threshold
    found, i, n = [], 0, len(hot)
    while i < n:
        if not hot[i]:
            i += 1
            continue
        j = i
        while j < n and hot[j] and (kappa[j] > 0) == (kappa[i] > 0):
            j += 1
        dtheta = float(_trapezoid(kappa[i:j], s[i:j])) if j - i > 1 else 0.0
        in_junction = any(lo <= s[j - 1] and s[i] <= hi for lo, hi in junctions)
        if abs(dtheta) >= min_heading_change and in_junction:
            side = "TurnLeft" if dtheta > 0 else "TurnRight"
            found.append(dict(type=side, start_s=float(s[i]),
                              end_s=float(s[j - 1]),
                              stop_position_xy=frame.to_cartesian(float(s[i]))))
        i = j
    return found


def _resolve_overlaps(goals: list[StaticGoal]) -> list[StaticGoal]:
    """Priority-based overlap trimming (the reference's
    `_straighten_static_route_plan` recursion, path_planner.py:673-867,
    restated as a fixed-point sweep): on overlap the lower-priority goal is
    trimmed away from the higher-priority one and dropped when empty."""
    for _ in range(16):  # fixed-point; plans are short
        goals.sort(key=lambda g: (g.start_s, -g.priority))
        changed = False
        out = []
        for g in goals:
            if g.end_s - g.start_s <= 1e-9:
                changed = True
                continue
            keep = True
            for h in out:
                if g.start_s >= h.end_s or g.end_s <= h.start_s:
                    continue  # no overlap
                changed = True
                if g.priority > h.priority:
                    # g wins: trim h (already emitted → adjust in place)
                    if h.start_s < g.start_s and h.end_s > g.end_s:
                        # h spans g: keep the front part of h
                        h.end_s = g.start_s
                    elif h.start_s < g.start_s:
                        h.end_s = g.start_s
                    else:
                        h.start_s = g.end_s
                    if h.end_s - h.start_s <= 1e-9:
                        h.goal_type = "__drop__"
                else:
                    # h wins: trim g
                    if g.end_s > h.end_s:
                        g.start_s = h.end_s
                    else:
                        keep = False
                        break
            if keep and g.end_s - g.start_s > 1e-9:
                out.append(g)
        goals = [g for g in out if g.goal_type != "__drop__"]
        if not changed:
            break
    goals.sort(key=lambda g: g.start_s)
    return goals


def _fill_defaults(goals: list[StaticGoal], route_length: float) -> list[StaticGoal]:
    """Tile [0, route_length] with StaticDefault between goals
    (path_planner.py:829-860)."""
    plan: list[StaticGoal] = []
    cursor = 0.0
    for g in goals:
        if g.start_s > cursor + 1e-9:
            plan.append(StaticGoal("StaticDefault", cursor, g.start_s))
        plan.append(g)
        cursor = max(cursor, g.end_s)
    if cursor < route_length - 1e-9:
        plan.append(StaticGoal("StaticDefault", cursor, route_length))
    if not plan:
        plan = [StaticGoal("StaticDefault", 0.0, route_length)]
    return plan


def build_static_route_plan(
    scenario: Scenario,
    route_ids,
    frame,
    street_setting: str = "Urban",
    preparation_time: float = 3.0,
    goal_time: float = 2.0,
) -> list[StaticGoal]:
    """Full static planning pass (`RoutePlan.execute_static_planning`,
    path_planner.py:316-497)."""
    raw = (
        _detect_stop_line_goals(scenario, route_ids, frame)
        + _detect_crosswalks(scenario, route_ids, frame)
        + _detect_lane_merges(scenario, route_ids, frame)
        + _detect_road_exits(scenario, route_ids, frame)
        + _detect_intersections(scenario, route_ids, frame)
        + _detect_turns(scenario, route_ids, frame)
    )

    goals: list[StaticGoal] = []
    for item in raw:
        lid = item.get("lanelet_id")
        preds = scenario.lanelets[lid].predecessors if lid in scenario.lanelets else []
        speed = speed_limit_for_lanelets(scenario, [lid] + list(preds))
        if speed is None:
            speed = _DEFAULT_SPEED.get(street_setting, 50 / 3.6)
        speed = min(130 / 3.6, speed)
        prep_len = speed * preparation_time
        goal_len = speed * goal_time

        if item["type"] in ("StopSign", "YieldSign", "TrafficLight", "Crosswalk"):
            start_s = max(0.001, item["stop_position_s"] - goal_len)
            end_s = max(item["position_s"], item["stop_position_s"])
            goals.append(StaticGoal(item["type"], start_s, end_s,
                                    stop_point_s=item["stop_position_s"],
                                    stop_point_xy=item.get("stop_position_xy"),
                                    goal_object=item["obj"], goal_lanelet_id=lid))
            goals.append(StaticGoal("Prepare" + item["type"],
                                    max(0.001, start_s - prep_len), start_s,
                                    stop_point_s=item["stop_position_s"],
                                    stop_point_xy=item.get("stop_position_xy"),
                                    goal_object=item["obj"], goal_lanelet_id=lid))
        elif item["type"] in ("LaneMerge", "RoadExit"):
            end_s = item["position_s"]
            start_s = max(0.001, end_s - goal_len)
            goals.append(StaticGoal(item["type"], start_s, end_s, goal_lanelet_id=lid))
            goals.append(StaticGoal("Prepare" + item["type"],
                                    max(0.001, start_s - prep_len), start_s,
                                    goal_lanelet_id=lid))
        elif item["type"] in ("TurnLeft", "TurnRight"):
            # turn entry doubles as the yield line (same rationale as the
            # intersection entry below; turns outrank intersections in the
            # overlap resolution, GOAL_PRIORITY)
            start_s, end_s = item["start_s"], item["end_s"]
            goals.append(StaticGoal(item["type"], start_s, end_s,
                                    stop_point_s=start_s,
                                    stop_point_xy=item.get("stop_position_xy")))
            goals.append(StaticGoal("Prepare" + item["type"],
                                    max(0.001, start_s - prep_len), start_s,
                                    stop_point_s=start_s,
                                    stop_point_xy=item.get("stop_position_xy")))
        elif item["type"] == "Intersection":
            start_s, end_s = item["start_s"], item["end_s"]
            # yield line at the junction entry: without it the Stopping /
            # Waiting situations have nothing to arm a stop distance against
            # (the reference's intersection states are TODO stubs and never
            # stop either — this build makes them effective)
            goals.append(StaticGoal("Intersection", start_s, end_s,
                                    stop_point_s=start_s,
                                    stop_point_xy=item.get("stop_position_xy"),
                                    goal_lanelet_id=lid))
            goals.append(StaticGoal("PrepareIntersection",
                                    max(0.001, start_s - prep_len), start_s,
                                    stop_point_s=start_s,
                                    stop_point_xy=item.get("stop_position_xy"),
                                    goal_lanelet_id=lid))

    # drop yield/stop signs that duplicate an active traffic light at the same
    # stop line (path_planner.py:741-766)
    tl_stops = {round(g.stop_point_s or -1.0, 1) for g in goals
                if g.goal_type == "TrafficLight"}
    goals = [g for g in goals
             if not (g.goal_type in ("StopSign", "YieldSign",
                                     "PrepareStopSign", "PrepareYieldSign")
                     and round(g.stop_point_s or -1.0, 1) in tl_stops)]

    goals = _resolve_overlaps(goals)
    return _fill_defaults(goals, frame.length)
