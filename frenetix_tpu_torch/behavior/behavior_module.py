"""The port's own copy of `frenetix_tpu/behavior/behavior_module.py` (NumPy only).

Behavior module: FSM + path planner + velocity planner orchestration.

Port of the reference's `BehaviorModule`
(behavior_planner/behavior_module.py:25-409): per step it

  1. refreshes lanelet information (current lanelet, speed limit, street
     setting) and the closest preceding vehicle (:212-230),
  2. executes the hierarchical FSM (`EgoFSM.execute`),
  3. runs the path planner when the FSM requests a lane change —
     this *modifies the reference path* handed to the reactive planner
     (:146-151),
  4. runs the velocity planner (TTC/MAX) (:153-155),
  5. computes the stop point (s-position + target velocity) from the active
     static goal / TTC / final goal (:232-408),

and emits `BehaviorOutput {reference_path, desired_velocity, stop_point_s,
desired_velocity_stop_point, behavior_planner_state}` (:664-672) for the
planner interface.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from frenetix_tpu_torch.behavior.fsm import _STOPLINE_STATES, EgoFSM, FSMState
from frenetix_tpu_torch.behavior.path_planner import PathPlanner, route_lane_changes
from frenetix_tpu_torch.behavior.static_route import StaticGoal, build_static_route_plan
from frenetix_tpu_torch.behavior.velocity_planner import VelocityPlanner, VPState, stop_distance
from frenetix_tpu_torch.io.commonroad import speed_limit_for_lanelets

__all__ = ["BehaviorModule", "BehaviorOutput", "BMState", "PPState"]


# lanelet types → street setting (helper_functions.py:167-192)
_HIGHWAY_TYPES = ("highway", "interstate")


@dataclass
class PPState:
    """Path-planner state (`PathPlannerState`, behavior_module.py:568-578)."""

    static_route_plan: list = field(default_factory=list)
    route_plan_ids: list = field(default_factory=list)
    reference_path: Optional[np.ndarray] = None
    reference_path_ids: list = field(default_factory=list)
    frame: object = None
    final_s_position_interval: Optional[tuple[float, float]] = None
    final_s_position_center: Optional[float] = None
    reference_path_updated: bool = False


@dataclass
class BMState:
    """Shared blackboard (`BehaviorModuleState`, behavior_module.py:411-458)."""

    config: object = None
    vehicle_params: object = None
    scenario: object = None
    planning_problem: object = None
    ego_id: int = -1
    dt: float = 0.1
    goal_index: Optional[int] = None
    plan_dynamics_only: bool = False

    ego_state: object = None
    predictions: object = None
    # obstacle world view: the scenario by default; multi-agent sims replace
    # it with sim.world_view.WorldView so live agents are observed instead of
    # their stale recorded trajectories
    world: object = None
    time_step: int = 0

    FSM_state: FSMState = field(default_factory=FSMState)
    VP_state: VPState = field(default_factory=VPState)
    PP_state: PPState = field(default_factory=PPState)

    street_setting: str = "Urban"
    ref_position_s: float = 0.0
    current_lanelet_id: Optional[int] = None
    current_lanelet: object = None
    current_static_goal: Optional[StaticGoal] = None

    init_velocity: float = 0.0
    speed_limit: Optional[float] = None

    nav_lane_changes_left: int = 0
    nav_lane_changes_right: int = 0
    overtaking: bool = True
    future_factor: int = 1

    stop_point_s: Optional[float] = None
    hold_stop_s: Optional[float] = None   # latched stop point while Waiting*
    stop_point_dist: Optional[float] = None
    desired_velocity_stop_point: Optional[float] = None
    stop_point_mode: Optional[str] = None


@dataclass
class BehaviorOutput:
    """Planner-facing interface (`BehaviorOutput`, behavior_module.py:664-672).

    `reference_path` is None unless the path planner rebuilt it this step —
    the consumer swaps its coordinate system only on change."""

    desired_velocity: float = 0.0
    reference_path: Optional[np.ndarray] = None
    stop_point_s: Optional[float] = None
    desired_velocity_stop_point: float = 0.0
    behavior_planner_state: dict = field(default_factory=dict)


class BehaviorModule:
    def __init__(self, scenario, planning_problem, config, reference_path,
                 route_ids, ego_id: int = -1, msg_logger=None, log_path=None):
        """reference_path/route_ids: the navigation route from
        `planner.route.reference_path_for_problem` (the reference builds it
        with commonroad-route-planner, path_planner.py:143-265)."""
        bm = BMState()
        self.bm = bm
        bm.config = config
        bm.vehicle_params = config.vehicle
        bm.scenario = scenario
        bm.world = scenario
        bm.planning_problem = planning_problem
        bm.ego_id = ego_id
        bm.dt = config.behavior.dt
        bm.init_velocity = float(planning_problem.initial_state.velocity)
        self.cfg = config.behavior
        self.msg_logger = msg_logger

        # street setting + current lanelet at init (behavior_module.py:69-75)
        init = planning_problem.initial_state
        bm.ego_state = init
        self._collect_lanelet_information()
        bm.street_setting = self._street_setting()

        # path planner owns the reference path (behavior_module.py:79-84)
        self.path_planner = PathPlanner(bm, reference_path, route_ids)
        bm.PP_state.static_route_plan = build_static_route_plan(
            scenario, route_ids, bm.PP_state.frame, bm.street_setting,
            preparation_time=self.cfg.preparation_time,
            goal_time=self.cfg.goal_time,
        )
        bm.nav_lane_changes_left, bm.nav_lane_changes_right = (
            route_lane_changes(scenario, route_ids)
        )

        # goal s-interval + velocity interval (helper_functions.py:787-818)
        self._compute_goal_intervals()

        self.ego_fsm = EgoFSM(bm)
        self.velocity_planner = VelocityPlanner(bm)
        self.flags = {"stopping_for_traffic_light": None,
                      "waiting_for_green_light": None}

        # per-step behavior data log (the reference's BehaviorLogger.log_data
        # → behavior_logs/, behavior_module.py:54,188)
        self._log_file = None
        if log_path is not None:
            import csv
            import os

            os.makedirs(log_path, exist_ok=True)
            self._log_file = open(
                os.path.join(log_path, "behavior_log.csv"), "w", newline=""
            )
            self._log_writer = csv.writer(self._log_file, delimiter=";")
            self._log_writer.writerow([
                "time_step", "street_setting", "behavior_state_static",
                "situation_state_static", "behavior_state_dynamic",
                "situation_state_dynamic", "velocity", "desired_velocity",
                "goal_velocity", "velocity_mode", "TTC", "MAX",
                "stop_point_s", "stop_point_dist", "stop_point_mode",
                "desired_velocity_stop_point", "lane_change_target",
            ])

    def _log_step(self, out: BehaviorOutput):
        if self._log_file is None:
            return
        bm, fsm, vp = self.bm, self.bm.FSM_state, self.bm.VP_state
        fmt = lambda v: "" if v is None else (round(v, 4) if isinstance(v, float) else v)
        self._log_writer.writerow([
            bm.time_step, fsm.street_setting, fsm.behavior_state_static,
            fsm.situation_state_static, fsm.behavior_state_dynamic,
            fsm.situation_state_dynamic, fmt(float(bm.ego_state.velocity)),
            fmt(out.desired_velocity), fmt(vp.goal_velocity), vp.velocity_mode,
            fmt(vp.TTC), fmt(vp.MAX), fmt(bm.stop_point_s),
            fmt(bm.stop_point_dist), bm.stop_point_mode,
            fmt(out.desired_velocity_stop_point),
            fsm.lane_change_target_lanelet_id,
        ])
        self._log_file.flush()

    def close(self):
        if self._log_file is not None:
            self._log_file.close()
            self._log_file = None

    # ---------------------------------------------------------------- helpers
    def _street_setting(self) -> str:
        """Lanelet types → scenario tags → Urban default
        (helper_functions.py:167-192)."""
        ll = self.bm.current_lanelet
        ltype = (getattr(ll, "lanelet_type", "") or "").lower()
        if any(t in ltype for t in _HIGHWAY_TYPES):
            return "Highway"
        if "country" in ltype:
            return "Country"
        if "urban" in ltype:
            return "Urban"
        tags = [t.lower() for t in getattr(self.bm.scenario, "tags", [])]
        if "interstate" in tags or "highway" in tags:
            return "Highway"
        return "Urban"

    def _collect_lanelet_information(self):
        """current lanelet + speed limit (behavior_module.py:212-221 →
        get_lanelet_information, helper_functions.py:136-193)."""
        bm = self.bm
        pos = np.asarray(bm.ego_state.position)
        lids = bm.scenario.find_lanelets_by_position(pos)
        ref_ids = bm.PP_state.reference_path_ids if bm.PP_state.reference_path_ids else []
        cur = None
        if len(lids) == 1:
            cur = lids[0]
        elif len(lids) > 1:
            for lid in lids:
                if lid in ref_ids:
                    cur = lid
            if cur is None:
                cur = lids[0]
        elif bm.current_lanelet_id is not None:
            cur = bm.current_lanelet_id   # keep last known when off-lanelet
        if cur is not None:
            bm.current_lanelet_id = cur
            bm.current_lanelet = bm.scenario.lanelets.get(cur)
            bm.speed_limit = speed_limit_for_lanelets(bm.scenario, lids or [cur])

    def _closest_preceding_obstacle(self):
        """Closest obstacle ahead on the current lanelet chain
        (helper_functions.py:243-311): distances to the lead's rear bumper,
        current state read from the scenario."""
        from frenetix_tpu_torch.behavior.path_planner import consecutive_lanelet_chain

        bm, vp = self.bm, self.bm.VP_state
        vp.closest_preceding_vehicle = None
        vp.pos_preceding_veh = None
        vp.dist_preceding_veh = None
        vp.vel_preceding_veh = None
        if bm.current_lanelet_id is None:
            return
        chain = set(consecutive_lanelet_chain(bm.scenario, bm.current_lanelet_id))
        frame = bm.PP_state.frame
        best_s = None
        for ob in bm.world.dynamic_obstacles:
            if ob.obstacle_id == bm.ego_id:
                continue
            st = ob.state_at_time(bm.time_step)
            if st is None:
                continue
            lids = set(bm.scenario.find_lanelets_by_position(st.position))
            if not (chain & lids):
                continue
            s_obs, d_obs = frame.project(np.asarray(st.position))
            if s_obs <= bm.ref_position_s or abs(d_obs) > 4.0:
                continue
            if best_s is None or s_obs < best_s:
                best_s = s_obs
                vp.closest_preceding_vehicle = ob
                vp.pos_preceding_veh = np.asarray(st.position)
                vp.dist_preceding_veh = float(
                    np.linalg.norm(np.asarray(st.position) - np.asarray(bm.ego_state.position))
                    - ob.length / 2
                )
                vp.vel_preceding_veh = float(st.velocity)

    def _compute_goal_intervals(self):
        """Goal s-position interval on the reference path + goal velocity
        interval (helper_functions.py:787-818)."""
        bm = self.bm
        frame = bm.PP_state.frame
        goal_interval = None
        goal_index = None
        for idx, g in enumerate(bm.planning_problem.goals):
            polys = []
            if g.position_shape is not None:
                polys.append(np.asarray(g.position_shape))
            for lid in g.position_lanelets:
                ll = bm.scenario.lanelets.get(lid)
                if ll is not None:
                    polys.append(ll.polygon)
            if not polys:
                continue
            from frenetix_tpu_torch.io.commonroad import _point_in_ring

            s_hits = [
                float(frame.s[i])
                for i in range(0, len(frame.xy), 4)
                if any(_point_in_ring(frame.xy[i], ring) for ring in polys)
            ]
            if s_hits:
                goal_interval = (min(s_hits), max(s_hits))
                goal_index = idx
                break
        bm.PP_state.final_s_position_interval = goal_interval
        bm.PP_state.final_s_position_center = (
            (goal_interval[0] + goal_interval[1]) / 2 if goal_interval else None
        )
        bm.goal_index = goal_index

        vp = bm.VP_state
        vp.final_velocity_interval = None
        vp.final_velocity_center = None
        if goal_index is not None:
            g = bm.planning_problem.goals[goal_index]
            if g.velocity_interval is not None:
                lo, hi = g.velocity_interval
                vp.final_velocity_interval = (max(lo, 0.0), hi)
                vp.final_velocity_center = max((lo + hi) / 2.0, 0.0)

    # ---------------------------------------------------------------- execute
    def execute(self, predictions, ego_state, time_step: int) -> BehaviorOutput:
        """One behavior step (behavior_module.py:113-190).

        Idempotent per time step: a second call at the same step returns the
        cached output without advancing the FSM (the batched agent stepper
        runs behavior ahead of the fused cycle; host-fallback agents would
        otherwise execute it twice per step)."""
        if getattr(self, "_last_step", None) == int(time_step):
            return self._last_out
        bm = self.bm
        bm.predictions = predictions
        bm.ego_state = ego_state
        bm.time_step = int(time_step)
        bm.plan_dynamics_only = (
            int(time_step) % self.cfg.replanning_frequency != 0
        )
        bm.PP_state.reference_path_updated = False

        bm.ref_position_s = bm.PP_state.frame.project_s(
            np.asarray(ego_state.position)
        )
        bm.future_factor = int(ego_state.velocity // 4) + 1
        self._collect_lanelet_information()
        bm.street_setting = self._street_setting()
        self._closest_preceding_obstacle()

        # FSM
        self.ego_fsm.execute()

        # path planner (behavior_module.py:146-151)
        if not bm.plan_dynamics_only:
            if bm.FSM_state.do_lane_change:
                self.path_planner.execute_lane_change()
            if bm.FSM_state.undo_lane_change:
                self.path_planner.undo_lane_change()
                bm.FSM_state.undo_lane_change = False
                bm.FSM_state.undid_lane_change = True
        if bm.PP_state.reference_path_updated:
            # projections below must use the new frame
            bm.ref_position_s = bm.PP_state.frame.project_s(
                np.asarray(ego_state.position)
            )
            self._compute_goal_intervals()

        # velocity planner
        self.velocity_planner.execute()

        # stop point
        self._calculate_stopping_point()

        # braking envelope toward the stop point: the reference hands far-away
        # stop points to a t≤10 s stopping sampler
        # (reactive_planner_cpp.py:273-281); the cycle keeps its static
        # N=30 horizon, so the *approach* is enforced here instead — desired
        # velocity may not exceed what a comfortable deceleration to the stop
        # point's target velocity allows.  Close in (reachable within the
        # horizon) the planner's quintic stopping sampling takes over.
        vp = bm.VP_state
        if (bm.FSM_state.slowing_car_for_traffic_light
                and vp.stop_distance is not None
                and vp.desired_velocity is not None):
            # target the armed stop line itself (vp.stop_distance from
            # _arm_stop = distance to stop line / queue end), not the blended
            # stop point — the latter is comfort-derived and circular
            v_env = float(np.sqrt(
                2.0 * self.cfg.comfortable_deceleration_rate
                * max(vp.stop_distance, 0.0)
            ))
            if v_env < vp.desired_velocity:
                vp.desired_velocity = v_env
                vp.velocity_mode = "stop-line envelope"

        self.flags["stopping_for_traffic_light"] = bm.FSM_state.slowing_car_for_traffic_light
        self.flags["waiting_for_green_light"] = bm.FSM_state.waiting_for_green_light

        out = BehaviorOutput()
        out.reference_path = (
            bm.PP_state.reference_path if bm.PP_state.reference_path_updated else None
        )
        v_des = bm.VP_state.desired_velocity
        out.desired_velocity = float(v_des if v_des is not None else ego_state.velocity)
        out.stop_point_s = bm.stop_point_s
        out.desired_velocity_stop_point = float(bm.desired_velocity_stop_point or 0.0)
        out.behavior_planner_state = self._bp_state_dict()
        self._log_step(out)
        self._last_step, self._last_out = int(time_step), out
        return out

    def _bp_state_dict(self) -> dict:
        """`BehaviorPlannerState.set_values` (behavior_module.py:623-661)."""
        bm, fsm, vp = self.bm, self.bm.FSM_state, self.bm.VP_state
        return {
            "street_setting": fsm.street_setting,
            "behavior_state_static": fsm.behavior_state_static,
            "situation_state_static": fsm.situation_state_static,
            "behavior_state_dynamic": fsm.behavior_state_dynamic,
            "situation_state_dynamic": fsm.situation_state_dynamic,
            "lane_change_target_lanelet_id": fsm.lane_change_target_lanelet_id,
            "slowing_car_for_traffic_light": fsm.slowing_car_for_traffic_light,
            "waiting_for_green_light": fsm.waiting_for_green_light,
            "velocity": getattr(bm.ego_state, "velocity", bm.init_velocity),
            "goal_velocity": vp.goal_velocity,
            "desired_velocity": vp.desired_velocity,
            "TTC": vp.TTC,
            "MAX": vp.MAX,
            "condition_factor": vp.condition_factor,
            "reference_path_ids": list(bm.PP_state.reference_path_ids),
            "stop_point_dist": bm.stop_point_dist,
            "desired_velocity_stop_point": bm.desired_velocity_stop_point,
            "stop_point_mode": bm.stop_point_mode,
        }

    # ------------------------------------------------------------- stop point
    def _calculate_stopping_point(self):
        """Stop point from static goal / TTC / final goal
        (behavior_module.py:232-408)."""
        bm, vp, fsm, cfg = self.bm, self.bm.VP_state, self.bm.FSM_state, self.cfg
        comfort_s = bm.ref_position_s + vp.comfortable_stopping_distance
        min_dist = max(cfg.min_stop_point_dist,
                       cfg.min_stop_point_time * bm.ego_state.velocity)
        default_time_s = (bm.ref_position_s
                          + bm.ego_state.velocity * cfg.default_time_horizon)

        situation = fsm.situation_state_static or ""
        goal = bm.current_static_goal

        if fsm.behavior_state_static in _ARMED_STATIC_STATES and goal is not None \
                and goal.stop_point_s is not None:
            if situation.startswith("Observing"):
                bm.stop_point_s = min(goal.stop_point_s, comfort_s)
                bm.desired_velocity_stop_point = vp.goal_velocity
            elif situation == "SlowingDown":
                bm.stop_point_s = min(goal.stop_point_s, comfort_s)
                bm.desired_velocity_stop_point = 0.0
            elif situation == "GreenLight" or situation.endswith("Clear"):
                bm.stop_point_s = max(goal.stop_point_s, comfort_s, default_time_s)
                bm.desired_velocity_stop_point = vp.goal_velocity
            elif situation == "Stopping":
                bm.stop_point_s = min(goal.stop_point_s, comfort_s)
                bm.desired_velocity_stop_point = 0.0
            elif situation.startswith("Waiting"):
                # hold position (behavior_module.py:292-299) — latched on
                # entry: re-deriving it from the advancing ego position each
                # step (as the reference does) lets the vehicle creep across
                # the stop line at ~0.1 m/s
                if bm.hold_stop_s is None:
                    bm.hold_stop_s = bm.ref_position_s
                bm.stop_point_s = bm.hold_stop_s
                bm.desired_velocity_stop_point = 0.0
                bm.stop_point_dist = bm.stop_point_s - bm.ref_position_s
                bm.stop_point_mode = "s-pos: current position | vel: 0"
                return
            else:  # ContinueDriving / unknown (behavior_module.py:300-305)
                bm.stop_point_s = max(comfort_s, default_time_s)
                bm.desired_velocity_stop_point = vp.goal_velocity
            # the latched Waiting hold ends with any non-Waiting situation
            bm.hold_stop_s = None
        else:
            bm.stop_point_s = max(comfort_s, default_time_s)
            bm.desired_velocity_stop_point = vp.goal_velocity

        # TTC-based stop point (behavior_module.py:317-349)
        ttc_stop_s = None
        if vp.TTC is not None:
            ttc_stop_s = (bm.ref_position_s + vp.dist_preceding_veh
                          + vp.stop_dist_preceding_veh - (vp.min_safety_dist or 0.0))
            if vp.vel_preceding_veh < cfg.standing_obstacle_vel:
                stop_behind = (bm.ref_position_s + vp.dist_preceding_veh
                               - bm.vehicle_params.length / 2 - 0.5)
                bm.stop_point_s = min(comfort_s, stop_behind)
                bm.desired_velocity_stop_point = 0.0
                bm.stop_point_dist = bm.stop_point_s - bm.ref_position_s
                bm.stop_point_mode = "s-pos: preceding vehicle | vel: 0"
                return
            elif (fsm.behavior_state_static in ("TrafficLight", "Crosswalk",
                                                "StopSign", "YieldSign")
                  and situation == "Stopping" and goal is not None
                  and goal.stop_point_s is not None
                  and ttc_stop_s < goal.stop_point_s):
                bm.stop_point_s = min(ttc_stop_s, comfort_s)
                bm.desired_velocity_stop_point = min(vp.vel_preceding_veh,
                                                     bm.ego_state.velocity)
            else:
                bm.stop_point_s = min(ttc_stop_s, comfort_s)
                bm.desired_velocity_stop_point = vp.vel_preceding_veh

        # nose offset + minimum distance (behavior_module.py:351-355)
        bm.stop_point_s -= bm.vehicle_params.length / 2
        bm.stop_point_s = max(bm.ref_position_s + min_dist, bm.stop_point_s, 0.0)
        # never push the stop point past an armed stop line (the reference's
        # min-dist clamp can do exactly that on a fast approach, sending the
        # stopping sampler across the line)
        if (situation in ("SlowingDown", "Stopping") and goal is not None
                and goal.stop_point_s is not None):
            bm.stop_point_s = min(
                bm.stop_point_s, goal.stop_point_s - bm.vehicle_params.length / 2
            )

        # final-goal stop point (behavior_module.py:357-367)
        final_s, final_v, v_adapt_s = self._final_goal_stop()
        if final_s is not None:
            bm.stop_point_s = min(final_s, bm.stop_point_s)
        approx_next = (bm.ref_position_s + bm.ego_state.velocity * bm.dt
                       * cfg.replanning_frequency)
        if final_v is not None and v_adapt_s is not None and v_adapt_s <= approx_next:
            bm.desired_velocity_stop_point = final_v

        # stop-point mode bookkeeping (behavior_module.py:369-408)
        candidates = [
            ("static goal", None if goal is None or goal.stop_point_s is None
             else goal.stop_point_s - bm.vehicle_params.length / 2),
            ("final goal", None if final_s is None
             else final_s - bm.vehicle_params.length / 2),
            ("TTC", None if ttc_stop_s is None
             else ttc_stop_s - bm.vehicle_params.length / 2),
            ("minimal distance", bm.ref_position_s + min_dist),
            ("comfortable", comfort_s - bm.vehicle_params.length / 2),
            ("default time", default_time_s - bm.vehicle_params.length / 2),
        ]
        best_name, best_d = "default time", abs(bm.stop_point_s - candidates[-1][1])
        for name, s_pos in candidates:
            if s_pos is not None and abs(bm.stop_point_s - s_pos) < best_d:
                best_name, best_d = name, abs(bm.stop_point_s - s_pos)
        if bm.desired_velocity_stop_point == 0.0:
            vel_name = "0"
        elif final_v is not None and bm.desired_velocity_stop_point == final_v:
            vel_name = "final goal"
        elif bm.desired_velocity_stop_point == vp.vel_preceding_veh:
            vel_name = "preceding vehicle"
        elif bm.desired_velocity_stop_point == vp.goal_velocity:
            vel_name = "goal velocity"
        else:
            vel_name = "unknown"
        bm.stop_point_mode = f"s-pos: {best_name} | vel: {vel_name}"
        bm.stop_point_dist = bm.stop_point_s - bm.ref_position_s

    def _final_goal_stop(self):
        """(helper_functions.py:821-854)."""
        bm, cfg = self.bm, self.cfg
        final_s = final_v = v_adapt_s = None
        interval = bm.PP_state.final_s_position_interval
        if interval is not None:
            final_s = max(interval[1] - bm.vehicle_params.length / 2, interval[0])
        if bm.VP_state.final_velocity_center is not None:
            final_v = bm.VP_state.final_velocity_center
            decel_dist = (
                stop_distance(bm.ego_state.velocity, cfg.comfortable_deceleration_rate)
                - stop_distance(final_v, cfg.comfortable_deceleration_rate)
            )
            if interval is not None:
                if interval[0] <= bm.ref_position_s <= interval[1]:
                    v_adapt_s = bm.ref_position_s
                else:
                    v_adapt_s = max(interval[0] - decel_dist, bm.ref_position_s)
            else:
                g = (bm.planning_problem.goals[bm.goal_index]
                     if bm.goal_index is not None else None)
                t_int = getattr(g, "time_interval", None) if g is not None else None
                if t_int is not None and t_int[0] <= bm.time_step <= t_int[1]:
                    v_adapt_s = bm.ref_position_s
                elif t_int is not None:
                    avg_v = (bm.ego_state.velocity + final_v) / 2
                    decel_time = decel_dist / max(avg_v, 1e-6)
                    v_adapt_s = bm.ref_position_s + max(
                        t_int[0] - decel_time - bm.time_step, 0.0
                    ) * bm.ego_state.velocity
        return final_s, final_v, v_adapt_s


# the stop-point calculator arms on exactly the states whose exit clears the
# hold flags — ONE tuple, owned by the FSM (a diverging copy would let arming
# and clearing desynchronize)
_ARMED_STATIC_STATES = _STOPLINE_STATES
