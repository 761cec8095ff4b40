"""The port's own copy of `frenetix_tpu/behavior/fsm.py` (NumPy only).

Hierarchical behavior FSM: street setting → behavior → situation.

Port of the reference's three-layer ego FSM
(behavior_planner/utils/FSM_model.py:21-1861 +
FSM_logic_modules.py:20-1157).  Same layer structure and state names:

  street setting : Highway | Country | Urban
  static layer   : StaticDefault, (Prepare)TrafficLight, (Prepare)StopSign,
                   (Prepare)YieldSign, (Prepare)Crosswalk, (Prepare)LaneMerge,
                   (Prepare)RoadExit, (Prepare)TurnLeft/Right,
                   (Prepare)Intersection — driven by the static route plan
  dynamic layer  : DynamicDefault, NoLaneChanges,
                   Prepare/LaneChangeLeft|Right,
                   Prepare/Overtake/FinishOvertake
  situation layer: per behavior state (Observing*, SlowingDown, Stopping,
                   Waiting*, *Clear, GreenLight, ContinueDriving,
                   IdentifyTargetLane…, IdentifyFreeSpace…, PreparationsDone,
                   InitiateLaneChange, EgoVehicleBetweenTwoLanes,
                   LaneChangeComplete, …)

Instead of ~40 State classes wired through SimpleFSM dispatch tables, each
layer is a plain transition function over the shared blackboard:
this framework keeps behavior logic host-side and compact (SURVEY §7.2 #12).
Where the reference logic modules are explicit TODO stubs (stop/yield signs,
crosswalks, turns, intersections FSM_logic_modules.py:693-1157; overtaking
:843-922; lane-merge preparation via randint :548-582), this implementation
provides working clearance/obstacle-based logic with the same state
vocabulary, so the stop-point calculator (behavior_module._calculate_
stopping_point) behaves as specified for every state family.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

__all__ = ["FSMState", "EgoFSM"]


# situation states that keep the static goal's stop point "armed"
# (turn/intersection goals carry a junction-entry yield line since round 2's
# lane-conflict clearance — without arming, their Stopping/Waiting situations
# would have no stop distance to brake against)
_STOPLINE_STATES = (
    "PrepareTrafficLight", "TrafficLight", "PrepareCrosswalk", "Crosswalk",
    "PrepareYieldSign", "YieldSign", "PrepareStopSign", "StopSign",
    "PrepareIntersection", "Intersection",
    "PrepareTurnLeft", "TurnLeft", "PrepareTurnRight", "TurnRight",
)

# line markings that forbid crossing (FSM_logic_modules.py:127-135)
_NO_CROSS = ("solid", "broad_solid")


@dataclass
class FSMState:
    """Shared FSM blackboard (`FSMState`, behavior_module.py:461-525)."""

    street_setting: Optional[str] = None

    behavior_state_static: str = "StaticDefault"
    situation_state_static: Optional[str] = None
    behavior_state_dynamic: str = "DynamicDefault"
    situation_state_dynamic: Optional[str] = None

    situation_time_step_counter: int = 0
    detected_lanelets: Optional[list] = None

    lane_change_target_lanelet_id: Optional[int] = None
    lane_change_target_lanelet: object = None
    obstacles_on_target_lanelet: Optional[dict] = None

    overtake_lane_changes_offset: int = 0

    free_space_offset: float = 0.0
    change_velocity_for_lane_change: Optional[bool] = None
    free_space_on_target_lanelet: Optional[bool] = None

    lane_change_left_ok: Optional[bool] = None
    lane_change_right_ok: Optional[bool] = None
    lane_change_left_done: Optional[bool] = None
    lane_change_right_done: Optional[bool] = None

    lane_change_prep_right_abort: Optional[bool] = None
    lane_change_prep_left_abort: Optional[bool] = None
    lane_change_right_abort: Optional[bool] = None
    lane_change_left_abort: Optional[bool] = None

    no_auto_lane_change: bool = False

    turn_clear: Optional[bool] = None
    crosswalk_clear: Optional[bool] = None
    stop_yield_sign_clear: Optional[bool] = None
    intersection_clear: Optional[bool] = None

    do_lane_change: Optional[bool] = None
    undo_lane_change: Optional[bool] = None
    initiated_lane_change: Optional[bool] = None
    undid_lane_change: Optional[bool] = None

    traffic_light_state: Optional[str] = None
    slowing_car_for_traffic_light: Optional[bool] = None
    waiting_for_green_light: Optional[bool] = None

    # overtake bookkeeping (this build implements the reference's TODO states)
    overtake_target_obstacle_id: Optional[int] = None
    wait_counter: int = 0


class EgoFSM:
    """`EgoFSM` (FSM_model.py:21-73): executes all three layers per step."""

    def __init__(self, bm_state):
        self.bm = bm_state
        self.fsm = bm_state.FSM_state

    # ------------------------------------------------------------------ main
    def execute(self):
        bm, fsm = self.bm, self.fsm
        # street-setting layer (LogicStreetSetting, FSM_logic_modules.py:20-52)
        if fsm.street_setting != bm.street_setting:
            fsm.street_setting = bm.street_setting
            self._reset_static()
            self._reset_dynamic()

        # static layer — skipped on dynamics-only steps (FSM_model.py:164-169)
        if not bm.plan_dynamics_only:
            self._static_layer()

        # dynamic gating: any active static state freezes auto lane changes on
        # Highway/Country (FSM_model.py:178-181; Urban keeps them, :291-294)
        if fsm.street_setting in ("Highway", "Country"):
            fsm.no_auto_lane_change = fsm.behavior_state_static != "StaticDefault"
        else:
            fsm.no_auto_lane_change = False

        self._dynamic_layer()

    # ---------------------------------------------------------- static layer
    def _reset_static(self):
        self.fsm.behavior_state_static = "StaticDefault"
        self.fsm.situation_state_static = None

    def _reset_dynamic(self):
        self.fsm.behavior_state_dynamic = "DynamicDefault"
        self.fsm.situation_state_dynamic = None
        self.fsm.situation_time_step_counter = 0

    def _static_layer(self):
        """LogicBehaviorStatic (FSM_logic_modules.py:58-87) + the static
        state's situation FSM."""
        bm, fsm = self.bm, self.fsm
        for goal in bm.PP_state.static_route_plan or []:
            if goal.start_s <= bm.ref_position_s < goal.end_s:
                bm.current_static_goal = goal
                if fsm.behavior_state_static != goal.goal_type:
                    fsm.behavior_state_static = goal.goal_type
                    fsm.situation_state_static = None
                    fsm.wait_counter = 0
                    if goal.goal_type not in _STOPLINE_STATES:
                        # leaving a stop-line goal clears its hold flags, or a
                        # stale armed stop line would pin velocity at 0
                        fsm.slowing_car_for_traffic_light = False
                        fsm.waiting_for_green_light = False
                        bm.VP_state.stop_distance = None
                break

        state = fsm.behavior_state_static
        handler = _STATIC_SITUATIONS.get(state)
        if handler is not None:
            fsm.situation_state_static = handler(self, fsm.situation_state_static)
        else:
            fsm.situation_state_static = None

    # --------------------------------------------------------- dynamic layer
    def _dynamic_layer(self):
        """LogicHighwayDynamic / LogicUrbanDynamic / LogicCountryDynamic
        (FSM_logic_modules.py:90-356) + situation FSMs of the dynamic states."""
        bm, fsm = self.bm, self.fsm
        cur = fsm.behavior_state_dynamic

        # NoLaneChanges gating (the Urban variant's corrected condition —
        # LogicHighwayDynamic:115-118 re-enters DynamicDefault only when the
        # flag is *cleared*)
        if cur != "NoLaneChanges" and fsm.no_auto_lane_change and cur == "DynamicDefault":
            cur = "NoLaneChanges"
        if cur == "NoLaneChanges" and not fsm.no_auto_lane_change:
            cur = "DynamicDefault"

        # initiate lane change preparations (nav-driven, :121-137)
        if cur == "DynamicDefault" and not fsm.no_auto_lane_change and bm.time_step > 0:
            lc = self._nav_lane_change_direction()
            if lc == "right":
                cur = "PrepareLaneChangeRight"
                fsm.situation_state_dynamic = None
                fsm.situation_time_step_counter = 0
            elif lc == "left":
                cur = "PrepareLaneChangeLeft"
                fsm.situation_state_dynamic = None
                fsm.situation_time_step_counter = 0
            elif self._should_overtake():
                cur = "PrepareOvertake"
                fsm.situation_state_dynamic = None
                fsm.situation_time_step_counter = 0

        # abort preparations when the neighbor disappears (:141-146)
        if cur == "PrepareLaneChangeRight" and getattr(bm.current_lanelet, "adj_right", None) is None:
            cur = self._abort_prep()
        if cur == "PrepareLaneChangeLeft" and getattr(bm.current_lanelet, "adj_left", None) is None:
            cur = self._abort_prep()

        # run the situation FSM of the current dynamic state
        handler = _DYNAMIC_SITUATIONS.get(cur)
        if handler is not None:
            fsm.situation_state_dynamic = handler(self, fsm.situation_state_dynamic)
            fsm.situation_time_step_counter += 1
        else:
            fsm.situation_state_dynamic = None

        # preparation → execution (:148-158)
        if cur == "PrepareLaneChangeRight" and fsm.lane_change_right_ok:
            cur, fsm.lane_change_right_ok = "LaneChangeRight", None
            fsm.do_lane_change = True
            fsm.situation_state_dynamic = "InitiateLaneChange"
            fsm.situation_time_step_counter = 0
        if cur == "PrepareLaneChangeLeft" and fsm.lane_change_left_ok:
            cur, fsm.lane_change_left_ok = "LaneChangeLeft", None
            fsm.do_lane_change = True
            fsm.situation_state_dynamic = "InitiateLaneChange"
            fsm.situation_time_step_counter = 0

        # overtake phase progression (reference TODO — implemented here)
        if cur == "PrepareOvertake" and fsm.situation_state_dynamic == "AbortOvertake":
            fsm.overtake_target_obstacle_id = None
            cur = self._abort_prep()
        elif cur == "PrepareOvertake" and fsm.situation_state_dynamic == "PreparationsDone":
            # overtake = lane change left, tracked by the Overtake state
            fsm.lane_change_target_lanelet_id = getattr(bm.current_lanelet, "adj_left", None)
            fsm.do_lane_change = True
            fsm.initiated_lane_change = None
            fsm.overtake_lane_changes_offset = 1
            cur = "Overtake"
            fsm.situation_state_dynamic = "Overtaking"
            fsm.situation_time_step_counter = 0
        elif cur == "Overtake" and fsm.situation_state_dynamic == "OvertakeComplete":
            cur = "FinishOvertake"
            fsm.situation_state_dynamic = None
            fsm.situation_time_step_counter = 0
        elif cur == "FinishOvertake" and fsm.situation_state_dynamic == "PreparationsDone":
            fsm.lane_change_target_lanelet_id = getattr(bm.current_lanelet, "adj_right", None)
            fsm.do_lane_change = True
            fsm.initiated_lane_change = None
            fsm.overtake_lane_changes_offset = 0
            fsm.overtake_target_obstacle_id = None
            cur = "LaneChangeRight"
            fsm.situation_state_dynamic = "InitiateLaneChange"
            fsm.situation_time_step_counter = 0

        # lane change completed (:160-176)
        if cur == "LaneChangeRight" and fsm.lane_change_right_done:
            cur = self._complete_lane_change("right")
        if cur == "LaneChangeLeft" and fsm.lane_change_left_done:
            cur = self._complete_lane_change("left")

        # preparation aborted (:178-190)
        if cur == "PrepareLaneChangeRight" and fsm.lane_change_prep_right_abort:
            fsm.lane_change_prep_right_abort = False
            cur = self._abort_prep()
        if cur == "PrepareLaneChangeLeft" and fsm.lane_change_prep_left_abort:
            fsm.lane_change_prep_left_abort = False
            cur = self._abort_prep()

        # lane change aborted mid-maneuver (:192-202)
        if cur == "LaneChangeRight" and fsm.lane_change_right_abort:
            fsm.lane_change_right_abort = False
            fsm.undo_lane_change = True
            cur = "DynamicDefault"
        if cur == "LaneChangeLeft" and fsm.lane_change_left_abort:
            fsm.lane_change_left_abort = False
            fsm.undo_lane_change = True
            cur = "DynamicDefault"

        fsm.behavior_state_dynamic = cur

    # ------------------------------------------------------- dynamic helpers
    def _nav_lane_change_direction(self) -> Optional[str]:
        """Navigation-required lane change whose crossing is legal
        (FSM_logic_modules.py:121-137)."""
        bm = self.bm
        ll = bm.current_lanelet
        if ll is None:
            return None
        if bm.nav_lane_changes_right > 0 and ll.adj_right is not None \
                and ll.adj_right_same_direction \
                and ll.line_marking_right not in _NO_CROSS:
            return "right"
        if bm.nav_lane_changes_left > 0 and ll.adj_left is not None \
                and ll.adj_left_same_direction \
                and ll.line_marking_left not in _NO_CROSS:
            return "left"
        return None

    def _should_overtake(self) -> bool:
        """Overtake initiation (the reference's `add overtaking` TODO,
        FSM_logic_modules.py:138,238): a clearly slower lead vehicle, a legal
        same-direction left neighbor, and no static goal nearby."""
        bm, vp = self.bm, self.bm.VP_state
        ll = bm.current_lanelet
        if ll is None or vp.dist_preceding_veh is None or vp.vel_preceding_veh is None:
            return False
        if not (ll.adj_left is not None and ll.adj_left_same_direction
                and ll.line_marking_left not in _NO_CROSS):
            return False
        limit = bm.speed_limit if bm.speed_limit is not None else vp.speed_limit_default
        slow_lead = vp.vel_preceding_veh < 0.6 * limit
        close = vp.dist_preceding_veh < max(3.0 * bm.ego_state.velocity, 25.0)
        return bool(bm.overtaking) and slow_lead and close

    def _abort_prep(self) -> str:
        fsm = self.fsm
        fsm.lane_change_target_lanelet_id = None
        fsm.lane_change_target_lanelet = None
        fsm.situation_state_dynamic = None
        return "DynamicDefault"

    def _complete_lane_change(self, side: str) -> str:
        bm, fsm = self.bm, self.fsm
        if side == "right":
            fsm.lane_change_right_done = None
            if bm.nav_lane_changes_right > 0:
                bm.nav_lane_changes_right -= 1
        else:
            fsm.lane_change_left_done = None
            if bm.nav_lane_changes_left > 0:
                bm.nav_lane_changes_left -= 1
        fsm.lane_change_target_lanelet_id = None
        fsm.lane_change_target_lanelet = None
        fsm.situation_state_dynamic = None
        return "DynamicDefault"

    # --------------------------------------------------- perception helpers
    def _detected_lanelets(self) -> list[int]:
        """Lanelets overlapped by the (half-size) vehicle footprint
        (FSM_model.py:497-501)."""
        bm = self.bm
        L, W = bm.vehicle_params.length / 2, bm.vehicle_params.width / 2
        c, o = np.asarray(bm.ego_state.position), bm.ego_state.orientation
        rot = np.array([[np.cos(o), -np.sin(o)], [np.sin(o), np.cos(o)]])
        corners = c + (np.array([[L, W], [L, -W], [-L, -W], [-L, W]]) / 2) @ rot.T
        hits: set = set(bm.scenario.find_lanelets_by_position(c))
        for p in corners:
            hits.update(bm.scenario.find_lanelets_by_position(p))
        return sorted(hits)

    def _obstacles_on_lanelet(self, lanelet_id, search_radius=None) -> dict:
        """Predicted obstacles on a lanelet chain
        (helper_functions.py:314-343), read from the scenario's current
        states (the reference falls through to scenario states too,
        helper_functions.py:303-311)."""
        from frenetix_tpu_torch.behavior.path_planner import consecutive_lanelet_chain

        bm = self.bm
        if lanelet_id is None or lanelet_id not in bm.scenario.lanelets:
            return {}
        chain = set(consecutive_lanelet_chain(bm.scenario, lanelet_id))
        found = {}
        ego_pos = np.asarray(bm.ego_state.position)
        for ob in bm.world.dynamic_obstacles:
            if ob.obstacle_id == bm.ego_id:
                continue
            st = ob.state_at_time(bm.time_step)
            if st is None:
                continue
            if search_radius is not None and np.linalg.norm(
                    np.asarray(st.position) - ego_pos) > search_radius:
                continue
            lids = bm.scenario.find_lanelets_by_position(st.position)
            if chain & set(lids):
                found[ob.obstacle_id] = (st, ob)
        return found

    def _free_space_on_target_lane(self, merge_mode: bool = False):
        """Velocity-dependent gap search with ego-position offsets
        (IdentifyFreeSpaceOnTargetLane…, FSM_model.py:1443-1587).  Sets
        free_space_on_target_lanelet / free_space_offset /
        change_velocity_for_lane_change."""
        bm, fsm = self.bm, self.fsm
        obstacles = fsm.obstacles_on_target_lanelet or {}
        if not obstacles:
            fsm.free_space_on_target_lanelet = True
            return
        if merge_mode:
            offsets = [0] + [v for k in range(1, 16) for v in (-k, k)]
            risk = 1.0
        else:
            offsets = [0] + [-k for k in range(1, 16)]
            risk = 1.1
        frame = bm.PP_state.frame
        L, v_ego = bm.vehicle_params.length, bm.ego_state.velocity
        fsm.free_space_offset = 0.0
        # the projection is independent of the ego offset — hoist it
        s_obs_all = [frame.project_s(st.position) for st, _ob in obstacles.values()]
        for off in offsets:
            free = True
            for s_obs in s_obs_all:
                ref_s = bm.ref_position_s + off
                if s_obs <= ref_s:
                    if not (s_obs < ref_s - L / 2 - v_ego / 2 * risk):
                        free = False
                else:
                    if not (s_obs > ref_s + L + v_ego / 2 * risk):
                        free = False
            if free:
                if off == 0:
                    fsm.free_space_on_target_lanelet = True
                else:
                    fsm.free_space_offset = float(off)
                    fsm.change_velocity_for_lane_change = True
                return
        fsm.free_space_on_target_lanelet = False

    def _stop_point_clear(self, radius: float = 12.0,
                          pedestrians_only: bool = False) -> bool:
        """Crossing-traffic clearance around the active stop point: no foreign
        obstacle within `radius` of the stop point that is moving (working
        replacement for the reference's TODO clearance logic)."""
        bm = self.bm
        goal = bm.current_static_goal
        if goal is None or goal.stop_point_s is None:
            return True
        p_stop = bm.PP_state.frame.to_cartesian(goal.stop_point_s)
        for ob in bm.world.dynamic_obstacles:
            if ob.obstacle_id == bm.ego_id:
                continue
            if pedestrians_only and ob.obstacle_type != "pedestrian":
                continue
            st = ob.state_at_time(bm.time_step)
            if st is None:
                continue
            if np.linalg.norm(np.asarray(st.position) - p_stop) < radius \
                    and st.velocity > 0.3:
                return False
        return True

    # ------------------------------------------------- lane-conflict clearance
    def _conflict_clear(self, pedestrians_only: bool = False) -> bool:
        """Lane-conflict clearance for the turn/intersection situations.

        Instead of the stop-point radius scan, reason about which traffic
        actually CROSSES the ego's route through the junction and when:

          1. the ego's conflict zone is the set of its route lanelets that
             are successors of an intersection incoming (the same lanelet
             set the ET/PET conflict-area metrics use),
          2. every moving foreign vehicle is propagated along its own
             lanelet successor chains at its current speed,
          3. the junction is clear iff no such vehicle is inside the zone
             now, and none arrives before the ego has cleared the zone plus
             a safety time gap (`behavior.intersection_time_gap`).

        Standing traffic outside the zone does not block (this is also the
        livelock tie-break when two agents yield to each other: both halt,
        both become clear, and whichever enters the zone first re-blocks
        the other).  Falls back to `_stop_point_clear` when the scenario
        has no intersection elements or the route does not pass through
        one.  The reference leaves this clearance logic as TODO stubs
        (FSM_logic_modules.py:1006-1157); this is a working lane-conflict
        model behind the same state machinery.
        """
        from frenetix_tpu_torch.io.commonroad import _point_in_ring
        from frenetix_tpu_torch.behavior.static_route import intersection_successor_ids

        bm = self.bm
        cfg = bm.config.behavior
        inter_lls = intersection_successor_ids(bm.scenario)
        route_ids = bm.PP_state.reference_path_ids or []
        conflict_ids = [lid for lid in route_ids
                        if lid in inter_lls and lid in bm.scenario.lanelets]
        if not conflict_ids:
            return self._stop_point_clear(pedestrians_only=pedestrians_only)
        ego_rings = [bm.scenario.lanelets[c].polygon for c in conflict_ids]

        # ego s-interval over the conflict zone (sampled at ~1 m on the
        # reference frame, windowed around the current position)
        frame = bm.PP_state.frame
        ds = float(frame.s[1] - frame.s[0]) if len(frame.s) > 1 else 1.0
        stride = max(int(round(1.0 / max(ds, 1e-6))), 1)
        lo, hi = bm.ref_position_s - 10.0, bm.ref_position_s + 150.0
        inside = [i for i in range(0, len(frame.xy), stride)
                  if lo <= frame.s[i] <= hi
                  and any(_point_in_ring(frame.xy[i], r) for r in ego_rings)]
        if not inside:
            return self._stop_point_clear(pedestrians_only=pedestrians_only)
        # clamp to the FIRST junction ahead: a route crossing two
        # intersections must be gated one at a time, not as a single 150 m
        # mega-zone (that would demand an impossible gap across both and let
        # a queue standing in the FAR junction block the near, empty one).
        # Tolerate gaps of ≤ 2 samples so a missed boundary point between
        # two lanelets of the SAME junction does not split it.
        run = [inside[0]]
        for i in inside[1:]:
            if i - run[-1] <= 2 * stride:
                run.append(i)
            else:
                break
        ego_rings = [r for r in ego_rings
                     if any(_point_in_ring(frame.xy[i], r) for i in run)]
        s_out = float(frame.s[run[-1]])
        d_clear = s_out + bm.vehicle_params.length - bm.ref_position_s
        if d_clear <= 0.0:
            return True  # already past the junction

        # time for the ego to clear the zone: accelerate from the current
        # velocity toward the attainable speed, capped
        v0 = max(float(bm.ego_state.velocity), 0.0)
        v_cap = max(bm.VP_state.goal_velocity or 0.0, bm.speed_limit or 0.0, 3.0)
        a = cfg.clearance_accel
        d_acc = max((v_cap ** 2 - v0 ** 2) / (2.0 * a), 0.0)
        if d_clear <= d_acc:
            t_ego = (np.sqrt(v0 ** 2 + 2.0 * a * d_clear) - v0) / a
        else:
            t_ego = (max(v_cap - v0, 0.0) / a) + (d_clear - d_acc) / v_cap
        t_protect = float(t_ego) + cfg.intersection_time_gap

        for ob in bm.world.dynamic_obstacles:
            if ob.obstacle_id == bm.ego_id:
                continue
            if pedestrians_only and ob.obstacle_type != "pedestrian":
                continue
            st = ob.state_at_time(bm.time_step)
            if st is None:
                continue
            pos = np.asarray(st.position, dtype=np.float64)
            if any(_point_in_ring(pos, r) for r in ego_rings):
                return False  # inside the conflict zone right now
            v_obs = float(st.velocity)
            if v_obs <= 0.3:
                continue  # standing traffic does not cross
            if ob.obstacle_type in ("pedestrian", "bicycle"):
                # non-lane-bound actors: radial propagation — the lanelet
                # successor walk below follows heading-aligned ROAD topology
                # and would skip a pedestrian crossing the carriageway or
                # walking in from a sidewalk (no lanelet at all)
                dist = _distance_to_rings(pos, ego_rings) - ob.length / 2.0
                t_in = max(dist, 0.0) / v_obs
            else:
                t_in = self._arrival_time_in_rings(ob, st, ego_rings, v_obs,
                                                   t_protect)
            if t_in is not None and t_in < t_protect:
                return False
        return True

    def _arrival_time_in_rings(self, ob, st, rings, v_obs: float,
                               horizon: float):
        """Earliest time at which `ob`'s front can reach any of `rings`,
        propagating along its lanelet successor chains (direction-aligned
        with its heading) at constant speed; None if unreachable within
        `horizon` seconds."""
        from frenetix_tpu_torch.io.commonroad import _point_in_ring

        bm = self.bm
        lanelets = bm.scenario.lanelets
        pos = np.asarray(st.position, dtype=np.float64)
        heading = np.array([np.cos(st.orientation), np.sin(st.orientation)])
        d_max = v_obs * horizon + ob.length
        best = [np.inf]

        def walk(lid, pts, d0, visited):
            d = d0
            for p_a, p_b in zip(pts[:-1], pts[1:]):
                step = float(np.linalg.norm(p_b - p_a))
                if step < 1e-9:
                    continue
                n_sub = max(int(step / 2.0), 1)
                for k in range(1, n_sub + 1):
                    dq = d + step * k / n_sub
                    if dq >= min(best[0], d_max):
                        return
                    q = p_a + (p_b - p_a) * (k / n_sub)
                    if any(_point_in_ring(q, r) for r in rings):
                        best[0] = dq
                        return
                d += step
            ll = lanelets.get(lid)
            for s in (ll.successors if ll else []):
                if s not in visited and s in lanelets and d < min(best[0], d_max):
                    walk(s, lanelets[s].center_vertices, d, visited | {s})

        for lid in bm.scenario.find_lanelets_by_position(pos):
            ll = lanelets.get(lid)
            if ll is None or len(ll.center_vertices) < 2:
                continue
            cv = ll.center_vertices
            seg_i = int(np.argmin(np.linalg.norm(cv[:-1] - pos, axis=1)))
            tangent = cv[seg_i + 1] - cv[seg_i]
            norm = float(np.linalg.norm(tangent))
            if norm < 1e-9 or float(tangent @ heading) / norm < 0.0:
                continue  # lanelet runs against the vehicle's heading
            remaining = np.concatenate([pos[None, :], cv[seg_i + 1:]], axis=0)
            walk(lid, remaining, 0.0, frozenset({lid}))

        if not np.isfinite(best[0]):
            return None
        return max(best[0] - ob.length / 2.0, 0.0) / v_obs


def _distance_to_rings(pos: np.ndarray, rings) -> float:
    """Euclidean distance from `pos` to the nearest edge of any polygon ring
    (projection onto ring segments, 0 inside is not special-cased — callers
    test ring membership separately)."""
    best = np.inf
    for r in rings:
        a = np.asarray(r, dtype=np.float64)
        b = np.roll(a, -1, axis=0)
        ab = b - a
        length2 = np.maximum((ab * ab).sum(axis=1), 1e-12)
        t = np.clip(((pos[None, :] - a) * ab).sum(axis=1) / length2, 0.0, 1.0)
        proj = a + t[:, None] * ab
        best = min(best, float(np.linalg.norm(proj - pos[None, :], axis=1).min()))
    return best


# ===========================================================================
# situation-layer transition functions
# state → new state; side effects on the blackboard mirror the reference's
# situation State.execute() actions (FSM_model.py:1397-1847)
# ===========================================================================


def _arm_stop(ego: EgoFSM):
    """Stopping/SlowingDown action: distances to the stop line
    (FSM_model.py:1716-1772) incl. queueing behind a stopping lead."""
    bm, vp = ego.bm, ego.bm.VP_state
    ego.fsm.slowing_car_for_traffic_light = True
    goal = bm.current_static_goal
    if goal is None or goal.stop_point_s is None:
        return
    vp.dist_to_tl = goal.stop_point_s - bm.ref_position_s - bm.vehicle_params.length
    vp.stop_distance = vp.dist_to_tl
    if vp.dist_preceding_veh is not None and vp.closest_preceding_vehicle is not None:
        lead_len = getattr(vp.closest_preceding_vehicle, "length", 4.5)
        queue_dist = vp.dist_preceding_veh - bm.vehicle_params.length - lead_len
        if queue_dist <= vp.dist_to_tl:
            vp.stop_distance = queue_dist


def _situation_prepare_light(ego: EgoFSM, state):
    """LogicPrepareTrafficLight (FSM_logic_modules.py:925-957)."""
    fsm = ego.fsm
    goal = ego.bm.current_static_goal
    if goal is not None and goal.goal_object is not None:
        fsm.traffic_light_state = goal.goal_object.state_at_time(ego.bm.time_step)
    state = state or "ObservingTrafficLight"
    if state == "ObservingTrafficLight" and fsm.traffic_light_state != "green":
        state = "SlowingDown"
    elif state == "SlowingDown" and fsm.traffic_light_state in ("green", "redYellow"):
        state = "ObservingTrafficLight"
    if state == "SlowingDown":
        _arm_stop(ego)
    else:
        fsm.slowing_car_for_traffic_light = False
    return state


def _situation_light(ego: EgoFSM, state):
    """LogicTrafficLight (FSM_logic_modules.py:960-1003)."""
    bm, fsm = ego.bm, ego.fsm
    goal = bm.current_static_goal
    if goal is not None and goal.goal_object is not None:
        fsm.traffic_light_state = goal.goal_object.state_at_time(bm.time_step)
    if state is None:
        state = "GreenLight" if fsm.traffic_light_state == "green" else "Stopping"
    if state == "GreenLight":
        fsm.slowing_car_for_traffic_light = False
        if fsm.traffic_light_state != "green":
            state = "Stopping"
    elif state == "Stopping":
        if fsm.traffic_light_state in ("green", "redYellow"):
            state = "GreenLight"
        elif bm.ego_state.velocity <= 0.5:
            state = "WaitingForGreenLight"
            fsm.waiting_for_green_light = True
    elif state == "WaitingForGreenLight":
        if fsm.traffic_light_state in ("green", "redYellow"):
            state = "ContinueDriving"
            fsm.waiting_for_green_light = False
    if state in ("Stopping", "WaitingForGreenLight"):
        _arm_stop(ego)
    if state == "ContinueDriving":
        fsm.slowing_car_for_traffic_light = False
        fsm.waiting_for_green_light = False
    return state


def _make_sign_situation(clear_flag: str, clear_state: str, wait_state: str,
                         observe_state: str, require_full_stop: bool,
                         pedestrians_only: bool = False,
                         conflict: bool = False):
    """Factory for the stop-sign / yield-sign / crosswalk / turn /
    intersection situation families (same state skeleton, different clearance
    semantics).  Reference state classes: FSM_model.py:1243-1389; the logic
    modules are TODO stubs — implemented here with clearance scans.
    `conflict=True` (turns/intersections) replaces the stop-point radius scan
    with the lane-conflict time-gap model (`EgoFSM._conflict_clear`)."""

    def _clearance(ego: EgoFSM) -> bool:
        if conflict:
            return ego._conflict_clear(pedestrians_only=pedestrians_only)
        return ego._stop_point_clear(pedestrians_only=pedestrians_only)

    def prepare(ego: EgoFSM, state):
        fsm = ego.bm.FSM_state
        clear = _clearance(ego)
        setattr(fsm, clear_flag, clear)
        state = state or observe_state
        if state == observe_state and not clear:
            state = "SlowingDown"
        elif state == "SlowingDown" and clear:
            state = observe_state
        if state == "SlowingDown":
            _arm_stop(ego)
        else:
            # leaving SlowingDown must release the braking envelope (cf.
            # _situation_prepare_light) or the stale armed stop distance
            # pins the desired velocity near zero forever
            fsm.slowing_car_for_traffic_light = False
        return state

    def main(ego: EgoFSM, state):
        bm, fsm = ego.bm, ego.bm.FSM_state
        clear = _clearance(ego)
        setattr(fsm, clear_flag, clear)
        if state is None:
            state = "Stopping" if (require_full_stop or not clear) else clear_state
        if state == clear_state:
            fsm.slowing_car_for_traffic_light = False
            if not clear:
                state = "Stopping"
        elif state == "Stopping":
            _arm_stop(ego)
            if bm.ego_state.velocity <= 0.5:
                state = wait_state
                fsm.wait_counter = 0
            elif clear and not require_full_stop:
                state = clear_state
        elif state == wait_state:
            _arm_stop(ego)
            fsm.wait_counter += 1
            # stop signs demand a full stop of ≥1 s before continuing
            min_wait = int(1.0 / bm.dt) if require_full_stop else 0
            if clear and fsm.wait_counter >= min_wait:
                state = "ContinueDriving"
        if state == "ContinueDriving":
            fsm.slowing_car_for_traffic_light = False
            fsm.waiting_for_green_light = False
        return state

    return prepare, main


_prep_stop_sign, _situation_stop_sign = _make_sign_situation(
    "stop_yield_sign_clear", "StopYieldSignClear",
    "WaitingForStopYieldSignClearance", "ObservingStopYieldSign",
    require_full_stop=True)
_prep_yield_sign, _situation_yield_sign = _make_sign_situation(
    "stop_yield_sign_clear", "StopYieldSignClear",
    "WaitingForStopYieldSignClearance", "ObservingStopYieldSign",
    require_full_stop=False)
_prep_crosswalk, _situation_crosswalk = _make_sign_situation(
    "crosswalk_clear", "CrosswalkClear", "WaitingForCrosswalkClearance",
    "ObservingCrosswalk", require_full_stop=False, pedestrians_only=True)
_prep_turn, _situation_turn = _make_sign_situation(
    "turn_clear", "TurnClear", "WaitingForTurnClearance",
    "IdentifyTargetLaneAndVehiclesOnTargetLane", require_full_stop=False,
    conflict=True)
_prep_intersection, _situation_intersection = _make_sign_situation(
    "intersection_clear", "IntersectionClear",
    "WaitingForIntersectionClearance", "ObservingIntersection",
    require_full_stop=False, conflict=True)


def _situation_prepare_lane_change(side: str):
    """LogicPrepareLaneChangeLeft/Right (FSM_logic_modules.py:361-494)."""

    def fn(ego: EgoFSM, state):
        bm, fsm = ego.bm, ego.fsm
        state = state or "IdentifyTargetLaneAndVehiclesOnTargetLane"
        if state == "IdentifyTargetLaneAndVehiclesOnTargetLane":
            # identify target lane + obstacles (FSM_model.py:1397-1430)
            ll = bm.current_lanelet
            target = ll.adj_left if side == "left" else ll.adj_right
            fsm.lane_change_target_lanelet_id = target
            fsm.lane_change_target_lanelet = bm.scenario.lanelets.get(target)
            fsm.obstacles_on_target_lanelet = ego._obstacles_on_lanelet(
                target, search_radius=bm.VP_state.speed_limit_default * 2)
            if fsm.obstacles_on_target_lanelet is not None:
                state = "IdentifyFreeSpaceOnTargetLaneForLaneChange"
                fsm.situation_time_step_counter = 0
        elif state == "IdentifyFreeSpaceOnTargetLaneForLaneChange":
            ego._free_space_on_target_lane(merge_mode=False)
            if fsm.situation_time_step_counter > 4 and not fsm.free_space_on_target_lanelet:
                state = "IdentifyTargetLaneAndVehiclesOnTargetLane"
                fsm.situation_time_step_counter = 0
            elif fsm.free_space_on_target_lanelet:
                state = "PreparationsDone"
                fsm.free_space_offset = 0.0
                fsm.change_velocity_for_lane_change = False
                if side == "left":
                    fsm.lane_change_left_ok = True
                else:
                    fsm.lane_change_right_ok = True
        return state

    return fn


def _situation_lane_change(side: str):
    """LogicLaneChangeLeft/Right (FSM_logic_modules.py:403-545)."""

    def fn(ego: EgoFSM, state):
        bm, fsm = ego.bm, ego.fsm
        state = state or "InitiateLaneChange"
        fsm.detected_lanelets = ego._detected_lanelets()
        if state == "InitiateLaneChange":
            if fsm.initiated_lane_change:
                fsm.initiated_lane_change = None
                fsm.do_lane_change = False
            if fsm.situation_time_step_counter > 16:
                if side == "left":
                    fsm.lane_change_left_abort = True
                else:
                    fsm.lane_change_right_abort = True
        if fsm.detected_lanelets is not None:
            if len(fsm.detected_lanelets) > 1 \
                    and fsm.lane_change_target_lanelet_id in fsm.detected_lanelets:
                state = "EgoVehicleBetweenTwoLanes"
            elif state == "EgoVehicleBetweenTwoLanes" \
                    and len(fsm.detected_lanelets) == 1 \
                    and bm.current_lanelet_id == fsm.lane_change_target_lanelet_id:
                state = "LaneChangeComplete"
                if side == "left":
                    fsm.lane_change_left_done = True
                else:
                    fsm.lane_change_right_done = True
                fsm.obstacles_on_target_lanelet = None
                fsm.free_space_on_target_lanelet = None
                fsm.initiated_lane_change = None
        return state

    return fn


def _situation_prepare_overtake(ego: EgoFSM, state):
    """PrepareOvertake situation chain (FSM_model.py:963-999; logic is a
    reference TODO, implemented: target = left lane, obstacles there must be
    faster than the slow lead or absent, then gap search)."""
    bm, fsm = ego.bm, ego.fsm
    state = state or "IdentifyTargetLaneAndVehiclesOnTargetLane"
    ll = bm.current_lanelet
    if state == "IdentifyTargetLaneAndVehiclesOnTargetLane":
        target = getattr(ll, "adj_left", None)
        if target is None:
            return state
        fsm.lane_change_target_lanelet_id = target
        fsm.lane_change_target_lanelet = bm.scenario.lanelets.get(target)
        fsm.obstacles_on_target_lanelet = ego._obstacles_on_lanelet(
            target, search_radius=bm.VP_state.speed_limit_default * 2)
        lead = bm.VP_state.closest_preceding_vehicle
        fsm.overtake_target_obstacle_id = getattr(lead, "obstacle_id", None)
        state = "IdentifySpeedOfObstaclesOnTargetLane"
    elif state == "IdentifySpeedOfObstaclesOnTargetLane":
        v_lead = bm.VP_state.vel_preceding_veh or 0.0
        slow_on_target = any(
            st.velocity < v_lead + 0.5
            for st, _ob in (fsm.obstacles_on_target_lanelet or {}).values()
        )
        state = "AbortOvertake" if slow_on_target \
            else "IdentifyFreeSpaceOnTargetLaneForLaneMerge"
    elif state == "IdentifyFreeSpaceOnTargetLaneForLaneMerge":
        ego._free_space_on_target_lane(merge_mode=True)
        if fsm.free_space_on_target_lanelet:
            state = "PreparationsDone"
    return state


def _situation_overtake(ego: EgoFSM, state):
    """Overtake progress: passing complete once ego is a vehicle length ahead
    of the overtaken obstacle (FSM_model.py:1002-1032; logic TODO upstream)."""
    bm, fsm = ego.bm, ego.fsm
    state = state or "Overtaking"
    if fsm.initiated_lane_change:
        fsm.initiated_lane_change = None
        fsm.do_lane_change = False
    if state == "Overtaking" and fsm.overtake_target_obstacle_id is not None:
        ob = bm.world.obstacles.get(fsm.overtake_target_obstacle_id)
        st = ob.state_at_time(bm.time_step) if ob is not None else None
        if st is not None:
            s_obs = bm.PP_state.frame.project_s(st.position)
            if bm.ref_position_s > s_obs + bm.vehicle_params.length + ob.length:
                state = "OvertakeComplete"
        else:
            state = "OvertakeComplete"
    return state


def _situation_finish_overtake(ego: EgoFSM, state):
    """FinishOvertake chain (FSM_model.py:1035-1069): right lane must be free
    to merge back."""
    bm, fsm = ego.bm, ego.fsm
    state = state or "IdentifyTargetLaneAndVehiclesOnTargetLane"
    ll = bm.current_lanelet
    if state == "IdentifyTargetLaneAndVehiclesOnTargetLane":
        target = getattr(ll, "adj_right", None)
        if target is None:
            return state
        fsm.lane_change_target_lanelet_id = target
        fsm.lane_change_target_lanelet = bm.scenario.lanelets.get(target)
        fsm.obstacles_on_target_lanelet = ego._obstacles_on_lanelet(
            target, search_radius=bm.VP_state.speed_limit_default * 2)
        state = "IdentifyFreeSpaceOnTargetLaneForLaneMerge"
    elif state == "IdentifyFreeSpaceOnTargetLaneForLaneMerge":
        ego._free_space_on_target_lane(merge_mode=True)
        if fsm.free_space_on_target_lanelet:
            state = "PreparationsDone"
    return state


def _situation_prepare_lane_merge(ego: EgoFSM, state):
    """LogicPrepareLaneMerge (FSM_logic_modules.py:548-582 — upstream gates on
    randint; here the chain advances on real conditions)."""
    bm, fsm = ego.bm, ego.fsm
    state = state or "EstimateMergingLaneLengthAndEmergencyStopPoint"
    if state == "EstimateMergingLaneLengthAndEmergencyStopPoint":
        state = "IdentifyTargetLaneAndVehiclesOnTargetLane"
    elif state == "IdentifyTargetLaneAndVehiclesOnTargetLane":
        # target = the merge goal lanelet from the static route plan
        # (FSM_model.py:1405-1414)
        target = None
        for goal in bm.PP_state.static_route_plan or []:
            if goal.goal_type == "LaneMerge" and goal.end_s >= bm.ref_position_s:
                target = goal.goal_lanelet_id
        fsm.lane_change_target_lanelet_id = target
        fsm.obstacles_on_target_lanelet = ego._obstacles_on_lanelet(
            target, search_radius=bm.VP_state.speed_limit_default * 2)
        state = "IdentifyFreeSpaceOnTargetLaneForLaneMerge"
    elif state == "IdentifyFreeSpaceOnTargetLaneForLaneMerge":
        ego._free_space_on_target_lane(merge_mode=True)
        if fsm.free_space_on_target_lanelet:
            state = "PreparationsDone"
    return state


def _situation_lane_merge(ego: EgoFSM, state):
    """LogicLaneMerge (FSM_logic_modules.py:585-626): predecessor containment
    of the occupied lanelets."""
    bm, fsm = ego.bm, ego.fsm
    state = state or "InitiateLaneMerge"
    goal = bm.current_static_goal
    goal_lid = getattr(goal, "goal_lanelet_id", None)
    if goal_lid is None or goal_lid not in bm.scenario.lanelets:
        return state
    occupied = ego._detected_lanelets()
    goal_ll = bm.scenario.lanelets[goal_lid]
    if state == "InitiateLaneMerge":
        if occupied and all(l in goal_ll.predecessors for l in occupied):
            state = "EgoVehicleBetweenTwoLanes"
    elif state == "EgoVehicleBetweenTwoLanes":
        if goal_lid in occupied:
            state = "BehaviorStateComplete"
    return state


def _situation_road_exit(ego: EgoFSM, state):
    """LogicRoadExit (FSM_logic_modules.py:661-690, randint upstream):
    advance once the exit lanelet is reached."""
    bm = ego.bm
    state = state or "InitiateRoadExit"
    goal = bm.current_static_goal
    goal_lid = getattr(goal, "goal_lanelet_id", None)
    occupied = ego._detected_lanelets()
    if state == "InitiateRoadExit" and goal_lid in occupied and len(occupied) > 1:
        state = "EgoVehicleBetweenTwoLanes"
    elif state in ("InitiateRoadExit", "EgoVehicleBetweenTwoLanes") \
            and occupied == [goal_lid]:
        state = "BehaviorStateComplete"
    return state


_STATIC_SITUATIONS = {
    "PrepareTrafficLight": _situation_prepare_light,
    "TrafficLight": _situation_light,
    "PrepareStopSign": _prep_stop_sign,
    "StopSign": _situation_stop_sign,
    "PrepareYieldSign": _prep_yield_sign,
    "YieldSign": _situation_yield_sign,
    "PrepareCrosswalk": _prep_crosswalk,
    "Crosswalk": _situation_crosswalk,
    "PrepareTurnLeft": _prep_turn,
    "TurnLeft": _situation_turn,
    "PrepareTurnRight": _prep_turn,
    "TurnRight": _situation_turn,
    "PrepareIntersection": _prep_intersection,
    "Intersection": _situation_intersection,
    "PrepareLaneMerge": _situation_prepare_lane_merge,
    "LaneMerge": _situation_lane_merge,
    "PrepareRoadExit": _situation_prepare_lane_merge,
    "RoadExit": _situation_road_exit,
}

_DYNAMIC_SITUATIONS = {
    "PrepareLaneChangeLeft": _situation_prepare_lane_change("left"),
    "PrepareLaneChangeRight": _situation_prepare_lane_change("right"),
    "LaneChangeLeft": _situation_lane_change("left"),
    "LaneChangeRight": _situation_lane_change("right"),
    "PrepareOvertake": _situation_prepare_overtake,
    "Overtake": _situation_overtake,
    "FinishOvertake": _situation_finish_overtake,
}
