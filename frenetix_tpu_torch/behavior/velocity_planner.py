"""The port's own copy of `frenetix_tpu/behavior/velocity_planner.py` (NumPy only).

Behavior velocity planner: TTC / MAX goal-velocity selection.

Port of the reference's `VelocityPlanner`
(behavior_planner/utils/velocity_planner.py:21-341):

  - MAX velocity   = (sign speed limit | street-setting default) × condition
    factor (:289-308),
  - TTC velocity   = preceding-vehicle velocity + (gap − safety distance) /
    ttc_norm, conditioned (:260-278),
  - safety distance with the four relative-motion situations (:174-258),
  - comfortable stopping distance (:280-287),
  - goal velocity  = min(MAX, TTC) (:144-171), optionally overridden by the
    final-goal velocity,
  - desired velocity = goal velocity clipped into the acceleration envelope
    (:105-142) with the lane-change gap-finding slow-down (:77-103) and the
    zero-velocity threshold.

Condition factors (driving dynamics / visibility) are 1.0 — the reference's
models are explicit stubs (velocity_planner.py:343-463).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

__all__ = ["VPState", "VelocityPlanner", "stop_distance"]


def stop_distance(velocity: float, deceleration: float) -> float:
    """|v²/(2a)| (helper_functions.py:132-133)."""
    return abs((velocity ** 2) / (-2.0 * deceleration))


_DEFAULT_SPEED_LIMIT = {
    "Highway": 130 / 3.6, "Country": 100 / 3.6, "Urban": 50 / 3.6,
}


@dataclass
class VPState:
    """Velocity-planner working state (`VelocityPlannerState`,
    behavior_module.py:528-566)."""

    desired_velocity: Optional[float] = None
    goal_velocity: Optional[float] = None
    velocity_mode: Optional[str] = None

    ttc_norm: float = 8.0
    final_velocity_interval: Optional[tuple[float, float]] = None
    final_velocity_center: Optional[float] = None
    speed_limit_default: float = 50 / 3.6
    TTC: Optional[float] = None
    MAX: Optional[float] = None
    comfortable_stopping_distance: float = 0.0

    closest_preceding_vehicle: object = None
    pos_preceding_veh: Optional[np.ndarray] = None
    dist_preceding_veh: Optional[float] = None
    vel_preceding_veh: Optional[float] = None
    ttc_relative: Optional[float] = None
    stop_dist_preceding_veh: Optional[float] = None
    min_safety_dist: Optional[float] = None
    safety_dist: Optional[float] = None

    condition_factor: float = 1.0
    lon_dyn_cond_factor: float = 1.0
    lat_dyn_cond_factor: float = 1.0
    visual_cond_factor: float = 1.0

    stop_distance: Optional[float] = None
    dist_to_tl: Optional[float] = None


class VelocityPlanner:
    def __init__(self, bm_state):
        """bm_state: behavior_module.BMState (shared blackboard)."""
        self.bm = bm_state
        self.vp = bm_state.VP_state
        self.cfg = bm_state.config.behavior
        self.vp.ttc_norm = self.cfg.ttc_norm
        self._set_default_speed_limit()

    # ------------------------------------------------------------------ steps
    def execute(self):
        """Per-step velocity planning (velocity_planner.py:55-75)."""
        self._calc_comfortable_stopping_distance()
        self._get_condition_factor()
        self._set_default_speed_limit()
        self._calc_max()
        self._calc_ttc()
        self._get_goal_velocity()
        self._set_desired_velocity()

    # --------------------------------------------------------------- internals
    def _set_default_speed_limit(self):
        self.vp.speed_limit_default = _DEFAULT_SPEED_LIMIT.get(
            self.bm.FSM_state.street_setting, 30 / 3.6
        )

    def _calc_max(self):
        limit = self.bm.speed_limit
        base = limit if limit is not None else self.vp.speed_limit_default
        self.vp.MAX = base * self.vp.condition_factor

    def _get_condition_factor(self):
        """Stub models keep every factor at 1.0 (velocity_planner.py:343-463)."""
        self.vp.lon_dyn_cond_factor = 1.0
        self.vp.lat_dyn_cond_factor = 1.0
        self.vp.visual_cond_factor = 1.0
        self.vp.condition_factor = (
            self.vp.lon_dyn_cond_factor * self.vp.lat_dyn_cond_factor
            * self.vp.visual_cond_factor
        )

    def _calc_comfortable_stopping_distance(self):
        v = self.bm.ego_state.velocity
        react = v * self.bm.dt * self.cfg.replanning_frequency
        self.vp.comfortable_stopping_distance = react + stop_distance(
            v, self.cfg.comfortable_deceleration_rate
        )

    def _calc_safety_distance(self) -> bool:
        """Four-situation reaction+stopping-distance model
        (velocity_planner.py:174-258).  Returns the `relevant` flag."""
        v_ego = self.bm.ego_state.velocity
        v_other = self.vp.vel_preceding_veh
        a_max = self.bm.vehicle_params.a_max
        len_ego = self.bm.vehicle_params.length
        dist = self.vp.dist_preceding_veh
        delta = self.bm.dt * self.cfg.replanning_frequency
        buf = self.cfg.safety_distance_buffer

        ego_react = v_ego * delta
        other_react = v_other * delta
        ego_stop = stop_distance(v_ego, a_max)
        other_stop = stop_distance(v_other, a_max)
        self.vp.stop_dist_preceding_veh = abs(other_stop)

        safety = len_ego / 2 + 0.5
        relevant = True
        if (dist >= 0 and v_ego >= 0 and v_other < 0) or (dist < 0 and v_ego < 0 and v_other >= 0):
            # driving towards each other
            safety += abs(ego_react) + abs(ego_stop) + abs(other_stop)
            self.vp.min_safety_dist = safety
            safety += max(v_ego * buf, v_other * buf)
        elif (dist >= 0 and v_ego >= 0 and v_other >= 0) or (dist < 0 and v_ego < 0 and v_other < 0):
            # ego behind other
            safety += abs(ego_react) + abs(ego_stop) - abs(other_stop)
            self.vp.min_safety_dist = safety
            safety += (v_other + v_ego) / 2 * buf
        elif (dist >= 0 and v_ego < 0 and v_other < 0) or (dist < 0 and v_ego >= 0 and v_other >= 0):
            # ego in front of other
            safety += abs(other_react) + abs(other_stop) - abs(ego_stop)
            self.vp.min_safety_dist = safety
            safety += (v_other + v_ego) / 2 * buf
            relevant = False
        else:
            # driving away from each other
            safety += -np.inf
            self.vp.min_safety_dist = safety
            relevant = False

        self.vp.safety_dist = safety
        return relevant

    def _calc_ttc(self):
        """TTC velocity (velocity_planner.py:260-278)."""
        if self.vp.dist_preceding_veh is None or self.vp.vel_preceding_veh is None:
            self.vp.TTC = None
            self.vp.stop_dist_preceding_veh = None
            self.vp.min_safety_dist = None
            return
        self._calc_safety_distance()
        self.vp.ttc_relative = (
            (self.vp.dist_preceding_veh - self.vp.safety_dist) / self.vp.ttc_norm
        )
        self.vp.TTC = (
            (self.vp.vel_preceding_veh + self.vp.ttc_relative)
            * self.vp.condition_factor
        )

    def _get_goal_velocity(self):
        """min(MAX, TTC) + final-goal override (velocity_planner.py:144-171)."""
        vp = self.vp
        if vp.MAX is None and vp.TTC is None:
            vp.goal_velocity = None
            vp.velocity_mode = None
        elif vp.MAX is None:
            vp.goal_velocity, vp.velocity_mode = vp.TTC, "TTC"
        elif vp.TTC is None:
            vp.goal_velocity, vp.velocity_mode = vp.MAX, "MAX"
        elif vp.MAX <= vp.TTC:
            vp.goal_velocity, vp.velocity_mode = vp.MAX, "MAX"
        else:
            vp.goal_velocity, vp.velocity_mode = vp.TTC, "TTC"

        if str(self.bm.stop_point_mode).endswith("final goal") and (
            vp.TTC is None
            or (self.bm.desired_velocity_stop_point is not None
                and self.bm.desired_velocity_stop_point < vp.TTC)
        ):
            vp.goal_velocity = self.bm.desired_velocity_stop_point
            vp.velocity_mode = "final"

    def _clip_velocity(self) -> float:
        """Acceleration-envelope clip (velocity_planner.py:105-142)."""
        input_vel = self.vp.goal_velocity
        v_ego = self.bm.ego_state.velocity
        a_max = self.bm.vehicle_params.a_max
        v_max = self.bm.vehicle_params.v_max
        v_min = 0.0
        delta = self.cfg.a_max_delta
        return min(
            max(
                input_vel,
                (v_ego - 2 * a_max * delta) if v_ego > 0 else (v_ego - a_max * delta),
                v_min if v_min <= v_ego else v_ego + a_max * delta,
            ),
            (v_ego + a_max * delta) if v_ego >= 0 else (v_ego + 2 * a_max * delta),
            v_max if v_max >= v_ego else v_ego - 2 * a_max * delta,
        )

    def _set_desired_velocity(self):
        """(velocity_planner.py:77-103)."""
        vp, fsm = self.vp, self.bm.FSM_state
        if vp.goal_velocity is None:
            vp.desired_velocity = self.bm.ego_state.velocity
            return
        vp.desired_velocity = self._clip_velocity()

        if fsm.change_velocity_for_lane_change:
            vp.desired_velocity = (
                self.bm.ego_state.velocity + fsm.free_space_offset * 0.75
            )
            fsm.change_velocity_for_lane_change = False

        if vp.desired_velocity <= self.cfg.zero_velocity_threshold:
            vp.desired_velocity = 0.0
