"""Route planning: lanelet-graph search → reference path polyline.

A copy of `frenetix_tpu/planner/route.py` (pure NumPy): the JAX module sits
behind `frenetix_tpu.planner`, whose package import loads JAX.

Replaces the reference's external `commonroad-route-planner` dependency
(`RoutePlanner(...).plan_routes()` + `extend_ref_path_both_ends` +
`smooth_ref_path`, cr_scenario_handler/planner_interfaces/frenet_interface.py:
101-114).  BFS over the lanelet digraph (successors + same-direction adjacent
lanelets as lane-change edges), preferring routes with fewer lane changes;
center vertices are concatenated, deduplicated and smoothed into the reference
path handed to `geometry.prepare_reference_path`.
"""
from __future__ import annotations

from collections import deque

import numpy as np

__all__ = ["plan_route", "reference_path_for_problem"]


def plan_route(scenario, start_lanelet_id: int, goal_lanelet_ids) -> list[int]:
    """Shortest lanelet sequence from start to any goal lanelet.

    Edge order (successor first, then adjacents) + BFS makes routes with fewer
    lane changes win ties.  Returns [] if unreachable.
    """
    goal_set = set(goal_lanelet_ids)
    if start_lanelet_id in goal_set:
        return [start_lanelet_id]
    lanelets = scenario.lanelets
    prev = {start_lanelet_id: None}
    q = deque([start_lanelet_id])
    while q:
        cur = q.popleft()
        ll = lanelets.get(cur)
        if ll is None:
            continue
        neighbors = list(ll.successors)
        if ll.adj_left is not None and ll.adj_left_same_direction:
            neighbors.append(ll.adj_left)
        if ll.adj_right is not None and ll.adj_right_same_direction:
            neighbors.append(ll.adj_right)
        for nb in neighbors:
            if nb in prev or nb not in lanelets:
                continue
            prev[nb] = cur
            if nb in goal_set:
                path = [nb]
                while prev[path[-1]] is not None:
                    path.append(prev[path[-1]])
                return path[::-1]
            q.append(nb)
    return []


def _arclength(pts: np.ndarray) -> np.ndarray:
    seg = np.linalg.norm(np.diff(pts, axis=0), axis=1)
    return np.concatenate([[0.0], np.cumsum(seg)])


def _resample(pts: np.ndarray, stations: np.ndarray) -> np.ndarray:
    s = _arclength(pts)
    return np.stack(
        [np.interp(stations, s, pts[:, 0]), np.interp(stations, s, pts[:, 1])],
        axis=1,
    )


def _project_onto_polyline(pts: np.ndarray, p: np.ndarray):
    """Closest point of `p` on the polyline `pts` (projection onto segments,
    not nearest vertex) and its arclength station."""
    a, b = pts[:-1], pts[1:]
    ab = b - a
    length2 = np.maximum((ab * ab).sum(axis=1), 1e-12)
    t = np.clip(((p[None, :] - a) * ab).sum(axis=1) / length2, 0.0, 1.0)
    proj = a + t[:, None] * ab
    i = int(np.argmin(np.linalg.norm(proj - p[None, :], axis=1)))
    s = _arclength(pts)
    return proj[i], float(s[i] + t[i] * np.sqrt(length2[i]))


def _blend_lane_change(tail: np.ndarray, verts: np.ndarray,
                       ramp_length: float = 30.0):
    """Smooth lateral transition from the current lane's centerline (`tail`)
    into the adjacent lane's (`verts`), centered on the overlap midpoint.

    The reference's external route planner emits a reference path that ramps
    into the goal lane over the lane-change span
    (commonroad-route-planner's lane-change section generation, consumed at
    frenet_interface.py:101-114); the round-1 version here instead switched
    centerlines at the nearest point to the PREVIOUS lanelet's end — for a
    goal on the neighbor lane that is a terminal 90° kink, which the
    downstream smoothing turns into a tight (r ≈ 5 m) hook that the static
    route planner then misreads as a street-corner turn.

    Returns (kept_tail, blend_samples, remaining_neighbor_verts).
    """
    s_tail = _arclength(tail)
    total = float(s_tail[-1])
    ramp = min(ramp_length, 0.6 * total)
    s0 = np.clip(0.5 * total - 0.5 * ramp, 0.0, total)
    s1 = min(s0 + ramp, total)
    s_verts = _arclength(verts)
    if s1 - s0 < 1e-6:  # degenerate short lanelet: plain switch at the joint
        _, s_join = _project_onto_polyline(verts, tail[-1])
        return tail, np.empty((0, 2)), verts[s_verts > s_join + 1e-6]

    stations = np.linspace(s0, s1, max(int((s1 - s0) / 2.0), 4))
    src = _resample(tail, stations)
    # matching points on the neighbor: projection onto the polyline per
    # sample (nearest-VERTEX matching corrupts the ramp on sparse-vertex
    # lanelets — a 2-vertex 300 m lanelet would snap every sample to an
    # endpoint and fold the centerline back on itself)
    proj = [_project_onto_polyline(verts, p) for p in src]
    dst = np.stack([q for q, _ in proj], axis=0)
    w = (stations - s0) / (s1 - s0)
    w = w * w * (3.0 - 2.0 * w)  # smoothstep
    blend = src * (1.0 - w)[:, None] + dst * w[:, None]
    kept = tail[s_tail < s0]
    rest = verts[s_verts > proj[-1][1] + 1e-6]
    return kept, blend, rest


def _route_centerline(scenario, route: list[int]) -> np.ndarray:
    """Concatenate the center vertices of a lanelet route, skipping duplicate
    joints; lane-change edges (same-direction adjacent lanelets) become a
    smooth mid-overlap lateral ramp (`_blend_lane_change`) rather than a
    centerline jump."""
    pts: list[np.ndarray] = []
    prev_ll = None
    for lid in route:
        ll = scenario.lanelets[lid]
        verts = ll.center_vertices
        if (prev_ll is not None
                and lid in (prev_ll.adj_left, prev_ll.adj_right)
                and pts and len(pts[-1]) >= 2):
            kept, blend, rest = _blend_lane_change(pts[-1], verts)
            pts[-1] = kept
            pts.extend([blend, rest])
        else:
            pts.append(verts)
        prev_ll = ll
    out = np.concatenate([p for p in pts if len(p)], axis=0)
    _, idx = np.unique(out, axis=0, return_index=True)
    return out[np.sort(idx)]


def reference_path_for_problem(scenario, planning_problem):
    """Initial state + goal region → raw reference-path polyline + route.

    Falls back to the longest successor chain from the start lanelet when the
    goal has no lanelet/position information (survival scenarios).
    Returns (polyline (P, 2), route list[int]).
    """
    init_pos = planning_problem.initial_state.position
    start_ids = scenario.find_lanelets_by_position(init_pos)
    if not start_ids:
        # nearest lanelet center as fallback
        best, best_d = None, np.inf
        for lid, ll in scenario.lanelets.items():
            d = np.min(np.linalg.norm(ll.center_vertices - init_pos[None], axis=1))
            if d < best_d:
                best, best_d = lid, d
        start_ids = [best]

    goal_ids = []
    for g in planning_problem.goals:
        goal_ids.extend(g.position_lanelets)
        if g.position_shape is not None:
            c = g.position_shape.mean(axis=0)
            goal_ids.extend(scenario.find_lanelets_by_position(c))

    route = []
    for sid in start_ids:
        if goal_ids:
            route = plan_route(scenario, sid, goal_ids)
        if route:
            break
    if not route:
        # survival: follow successors greedily from the first start lanelet
        route = [start_ids[0]]
        seen = set(route)
        while True:
            succ = [
                s
                for s in scenario.lanelets[route[-1]].successors
                if s in scenario.lanelets and s not in seen
            ]
            if not succ:
                break
            route.append(succ[0])
            seen.add(succ[0])

    return _route_centerline(scenario, route), route
