"""The port's own copy of `frenetix_tpu/behavior/path_planner.py` (NumPy only).

Behavior path planner: reference path ownership + lane-change maneuvers.

Port of the reference's `PathPlanner` / `ReferencePath`
(behavior_planner/utils/path_planner.py:28-288):

  - owns the agent's reference path + its lanelet id list,
  - extracts the navigation lane changes the route requires
    (helper_functions.py:438-453 + behavior_module.py:192-203),
  - `create_lane_change` rebuilds the reference path for a lane change: keep
    the old path up to (current position + future factor), continue on a
    straight centerline path of the target lanelet chain, smooth the joint
    (path_planner.py:270-288),
  - `undo_lane_change` = lane change back to the current lanelet.

The lanelet-chain / straight-path helpers mirror
helper_functions.py:397-470 (`create_consecutive_lanelet_id_list`,
`compute_straight_reference_path`).
"""
from __future__ import annotations

import numpy as np

from frenetix_tpu_torch.behavior.frame import HostFrame
from frenetix_tpu_torch.geometry.refpath import resample_polyline, smooth_polyline

__all__ = [
    "consecutive_lanelet_chain",
    "straight_centerline_path",
    "route_lane_changes",
    "PathPlanner",
]


def consecutive_lanelet_chain(scenario, start_lanelet_id: int,
                              preferred_ids=None) -> list[int]:
    """Follow successors from a lanelet, preferring lanelets of the existing
    navigation route and avoiding loops (helper_functions.py:397-435)."""
    chain = [start_lanelet_id]
    seen = {start_lanelet_id}
    while True:
        ll = scenario.lanelets.get(chain[-1])
        if ll is None or not ll.successors:
            break
        nxt = None
        if preferred_ids is not None:
            for s in ll.successors:
                if s in preferred_ids and s not in seen:
                    nxt = s
                    break
        if nxt is None:
            for s in ll.successors:
                if s not in seen:
                    nxt = s
                    break
        if nxt is None:
            break
        chain.append(nxt)
        seen.add(nxt)
    return chain


def straight_centerline_path(scenario, lanelet_ids, step: float = 0.5) -> np.ndarray:
    """Concatenated + resampled center vertices of a lanelet chain
    (helper_functions.py:456-470)."""
    parts = [scenario.lanelets[lid].center_vertices for lid in lanelet_ids
             if lid in scenario.lanelets]
    path = np.concatenate(parts, axis=0)
    # drop duplicate joints
    keep = np.concatenate([[True], np.linalg.norm(np.diff(path, axis=0), axis=1) > 1e-9])
    return resample_polyline(path[keep], step)


def route_lane_changes(scenario, route_ids) -> tuple[int, int]:
    """(left, right) lane changes the navigation route contains — consecutive
    route lanelets that are lateral neighbors (helper_functions.py:438-453 +
    behavior_module.py:192-203)."""
    left = right = 0
    for a, b in zip(route_ids[:-1], route_ids[1:]):
        ll = scenario.lanelets.get(a)
        if ll is None:
            continue
        if ll.adj_left == b:
            left += 1
        elif ll.adj_right == b:
            right += 1
    return left, right


class PathPlanner:
    def __init__(self, bm_state, polyline: np.ndarray, route_ids: list[int]):
        self.bm = bm_state
        self.pp = bm_state.PP_state
        self.scenario = bm_state.scenario
        self._set_path(np.asarray(polyline, dtype=np.float64), list(route_ids))
        self.pp.route_plan_ids = list(route_ids)

    def _set_path(self, polyline: np.ndarray, ids: list[int]):
        self.pp.reference_path = polyline
        self.pp.reference_path_ids = ids
        self.pp.frame = HostFrame(polyline)
        self.pp.reference_path_updated = True

    # ------------------------------------------------------------ lane change
    def execute_lane_change(self):
        """FSM `do_lane_change` action (path_planner.py:115-126)."""
        target = self.bm.FSM_state.lane_change_target_lanelet_id
        if target is None:
            return
        self._create_lane_change(target)
        self.bm.FSM_state.initiated_lane_change = True

    def undo_lane_change(self):
        """Abort: re-plan onto the currently occupied lanelet
        (path_planner.py:128-140)."""
        if self.bm.current_lanelet_id is None:
            return
        self._create_lane_change(self.bm.current_lanelet_id)

    def _create_lane_change(self, goal_lanelet_id: int,
                            number_vertices_lane_change: int = 6):
        """Rebuild the reference path through the target lanelet chain
        (path_planner.py:270-288).  future_factor grows with speed
        (behavior_module.py:139: v // 4 + 1) so faster vehicles get a longer
        transition arc; the resample step is 0.5 m so index offsets below are
        in half-meters."""
        ego_pos = np.asarray(self.bm.ego_state.position, dtype=np.float64)
        future = int(self.bm.future_factor)

        new_ids = consecutive_lanelet_chain(
            self.scenario, goal_lanelet_id, preferred_ids=set(self.pp.route_plan_ids)
        )
        old_path = resample_polyline(self.pp.reference_path, 0.5)
        new_path = straight_centerline_path(self.scenario, new_ids, step=0.5)

        cut_old = int(np.argmin(np.linalg.norm(old_path - ego_pos[None], axis=1)))
        cut_new = int(np.argmin(np.linalg.norm(new_path - ego_pos[None], axis=1)))
        # 0.5 m spacing → ×2 to keep the reference's meter-scale future factor
        old_keep = old_path[: cut_old + 2 * future, :]
        new_keep = new_path[cut_new + 2 * (future + number_vertices_lane_change):, :]
        if len(old_keep) < 2 or len(new_keep) < 2:
            return  # degenerate (end of route) — keep the current path
        joined = np.concatenate([old_keep, new_keep], axis=0)
        joined = smooth_polyline(resample_polyline(joined, 0.5))

        # keep ids: old route up to the current lanelet + the new chain
        cur = self.bm.current_lanelet_id
        ids = self.pp.reference_path_ids
        if cur in ids:
            ids = ids[: ids.index(cur) + 1]
        self._set_path(joined, list(dict.fromkeys(ids + new_ids)))
