"""Agent: one planning vehicle's lifecycle in the simulation.

PyTorch port of `frenetix_tpu/sim/agent.py`: per step collision → goal
check → replan every k-th step (or when no plan exists) → execute the next
planned state.  The replan goes through the planner interface named by
`simulation.used_planner_interface` (`sim.planner_interfaces` registry; the
default `FrenetPlannerInterface` drives the port's `ReactivePlanner` on the
agent's device).  With a responsibility weight the agent rasterizes the
obstacles' reach-set grids before each replan; with
`occlusion.use_occlusion_module` it owns an `OcclusionModule`; with
`behavior.use_behavior_planner` a `BehaviorModule`, which then drives the
desired velocity, the stop point and the reference path of every replan.
With a `log_dir` and `debug.activate_logging` the agent writes its
trajectory logs (`utils.trajectory_logging`) and the behavior log under
`log_dir/<agent id>`.
"""
from __future__ import annotations

import enum
import os
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from frenetix_tpu_torch.behavior import BehaviorModule
from frenetix_tpu_torch.io.commonroad import _point_in_ring
from frenetix_tpu_torch.occlusion import OcclusionModule, PhantomThresholds
from frenetix_tpu_torch.planner.initial_state import CartesianState
from frenetix_tpu_torch.planner.reactive import PlannedTrajectory, ReactivePlanner
from frenetix_tpu_torch.planner.route import reference_path_for_problem
from frenetix_tpu_torch.risk.reachable_set import build_reach_set_grids
from frenetix_tpu_torch.sim.planner_interfaces import get_planner_interface
from frenetix_tpu_torch.utils.trajectory_logging import TrajectoryLogger

__all__ = ["AgentStatus", "Agent", "EgoState"]


class AgentStatus(enum.IntEnum):
    """Same values as the JAX package's AgentStatus."""

    IDLE = 0
    RUNNING = 1
    COMPLETED_SUCCESS = 2
    TIMELIMIT = 3
    COLLISION = 4
    ERROR = 5


@dataclass
class EgoState:
    """Vehicle-center state (CommonRoad convention)."""

    time_step: int
    position: np.ndarray
    orientation: float
    velocity: float
    acceleration: float = 0.0
    yaw_rate: float = 0.0
    steering_angle: float = 0.0


@dataclass
class AgentRecord:
    states: list = field(default_factory=list)        # executed EgoStates
    planning_times: list = field(default_factory=list)
    # (wall time of the batched pass, agents in it) per batched replan
    batch_planning_times: list = field(default_factory=list)
    messages: list = field(default_factory=list)


class Agent:
    def __init__(self, agent_id: int, planning_problem, scenario, config,
                 device: torch.device, *, msg_logger=None, log_dir=None):
        self.id = agent_id
        self.problem = planning_problem
        self.scenario = scenario
        self.config = config
        self.status = AgentStatus.IDLE
        self.message = "initialized"
        self.record = AgentRecord()

        self.planner = ReactivePlanner(config, device, msg_logger)
        self.veh = config.vehicle
        self.interface = get_planner_interface(
            config.simulation.used_planner_interface)(self)
        self.dt = config.planning.dt
        self.k_replan = max(1, config.planning.replanning_frequency)

        polyline, self.route = reference_path_for_problem(scenario, planning_problem)
        self.planner.set_reference_path(
            polyline, scenario.drivable_polygons(),
            lanelets=list(scenario.lanelets.values())
            if config.cost_weights.get("lane_center_offset", 0) != 0 else None,
        )

        self.logger = None
        agent_log_dir = None
        if log_dir is not None and config.debug.activate_logging:
            agent_log_dir = os.path.join(log_dir, str(agent_id))
            self.logger = TrajectoryLogger(
                agent_log_dir,
                [k for k, v in config.cost_weights.items() if v != 0],
                config_dict={"cost_weights": config.cost_weights},
                save_all_traj=config.debug.save_all_traj,
                save_unweighted=config.debug.save_unweighted_costs,
                log_risk=config.debug.log_risk,
            )
            self.logger.write_reference_path(self.planner.ref_np.xy)

        init = planning_problem.initial_state
        self.state = EgoState(
            time_step=init.time_step,
            position=np.array(init.position, dtype=float),
            orientation=float(init.orientation),
            velocity=float(init.velocity),
            acceleration=float(init.acceleration),
            yaw_rate=float(init.yaw_rate),
        )
        self.record.states.append(self.state)

        self.current_plan: Optional[PlannedTrajectory] = None
        self.plan_step = 0            # index into the current plan
        self.x_cl = None              # curvilinear state carried between plans
        self._goal_s = self._compute_goal_s()
        self._goal_time = self._goal_time_interval()

        self.occlusion = None
        if config.occlusion.use_occlusion_module:
            occ = config.occlusion
            self.occlusion = OcclusionModule(
                scenario,
                sensor_radius=config.prediction.sensor_radius,
                max_phantoms=occ.max_phantoms,
                harm_threshold=occ.harm_threshold,
                risk_threshold=occ.risk_threshold,
                thresholds=PhantomThresholds.from_config(occ),
                phantom_type=occ.phantom_type,
                spawn_point_behind_dynamic_obstacle=occ.spawn_point_behind_dynamic_obstacle,
                spawn_point_behind_static_obstacle=occ.spawn_point_behind_static_obstacle,
                spawn_points_behind_turn=occ.spawn_points_behind_turn,
                max_dynamic_spawn_points=occ.max_dynamic_spawn_points,
                max_static_spawn_points=occ.max_static_spawn_points,
                variance_factor=occ.variance_factor,
                size_factor_length=occ.size_factor_length,
                size_factor_width=occ.size_factor_width,
                veh=config.vehicle,
                dt=config.planning.dt,
                route_xy=np.asarray(polyline),
            )

        # the behavior planner owns the reference path from here on
        self.behavior = None
        if config.behavior.use_behavior_planner:
            # behavior timing follows the planner
            config.behavior.dt = config.planning.dt
            config.behavior.replanning_frequency = config.planning.replanning_frequency
            self.behavior = BehaviorModule(
                scenario, planning_problem, config,
                reference_path=polyline, route_ids=self.route, ego_id=agent_id,
                msg_logger=msg_logger, log_path=agent_log_dir)

    # ------------------------------------------------------------------ goal
    def _goal_polygons(self, goal):
        polys = [self.scenario.lanelets[lid].polygon
                 for lid in goal.position_lanelets if lid in self.scenario.lanelets]
        if goal.position_shape is not None:
            polys.append(goal.position_shape)
        return polys

    def _compute_goal_s(self) -> Optional[float]:
        polys = [p for g in self.problem.goals for p in self._goal_polygons(g)]
        if not polys:
            return None
        ref = self.planner.ref_np
        s_vals = []
        for c in (p.mean(axis=0) for p in polys):
            d = np.linalg.norm(np.asarray(ref.xy) - c[None], axis=1)
            s_vals.append(float(np.asarray(ref.s)[int(np.argmin(d))]))
        return float(np.mean(s_vals))

    def _goal_time_interval(self):
        for g in self.problem.goals:
            if g.time_interval is not None:
                return g.time_interval
        return None

    def goal_reached(self) -> bool:
        """Position inside a goal lanelet/shape and velocity inside the goal
        interval (the time lower bound is not enforced)."""
        p = self.state.position
        for g in self.problem.goals:
            polys = self._goal_polygons(g)
            pos_ok = any(_point_in_ring(p, ring) for ring in polys) if polys else True
            vel_ok = True
            if g.velocity_interval is not None:
                lo, hi = g.velocity_interval
                vel_ok = lo <= self.state.velocity <= hi
            if pos_ok and vel_ok:
                return True
        return False

    def desired_velocity(self) -> float:
        """Distance-to-goal / remaining time, clipped to ±5 m/s of current."""
        v_cur = self.state.velocity
        if self._goal_s is None:
            return v_cur
        s_cur = self.x_cl[0][0] if self.x_cl is not None else 0.0
        dist = self._goal_s - s_cur
        if self._goal_time is not None:
            remaining = (self._goal_time[1] - self.state.time_step) * self.dt
        else:
            remaining = max(dist, 0.0) / max(v_cur, 1.0)
        if dist <= 2.0:
            for g in self.problem.goals:
                if g.velocity_interval is not None:
                    lo, hi = g.velocity_interval
                    return max(0.0, (lo + hi) / 2.0)
            return 0.0
        if remaining <= 0:
            return max(v_cur, 1.0)
        v_des = dist / remaining
        return float(np.clip(v_des, max(v_cur - 5.0, 0.0), v_cur + 5.0))

    # -------------------------------------------------------------- stepping
    def _rear_axle_state(self) -> CartesianState:
        wb = self.veh.wb_rear_axle
        return CartesianState(
            x=self.state.position[0] - wb * np.cos(self.state.orientation),
            y=self.state.position[1] - wb * np.sin(self.state.orientation),
            orientation=self.state.orientation,
            velocity=self.state.velocity,
            acceleration=self.state.acceleration,
            steering_angle=self.state.steering_angle,
            yaw_rate=self.state.yaw_rate,
        )

    def pre_step(self) -> AgentStatus:
        if self.status in (AgentStatus.COMPLETED_SUCCESS, AgentStatus.COLLISION,
                           AgentStatus.TIMELIMIT, AgentStatus.ERROR):
            return self.status
        self.status = AgentStatus.RUNNING
        if self.goal_reached():
            self.status = AgentStatus.COMPLETED_SUCCESS
            self.message = "success"
        return self.status

    def needs_replan(self) -> bool:
        return self.current_plan is None or self.plan_step >= self.k_replan

    def ensure_x_cl(self):
        if self.x_cl is None:
            self.x_cl = self.planner.compute_initial_state(self._rear_axle_state())
        return self.x_cl

    def apply_external_plan(self, plan) -> None:
        """Accept a plan computed by the batched stepper."""
        self.current_plan = plan
        self.plan_step = 0

    def update_planner(self, predictions, obstacle_xy, obstacle_valid):
        """Feed one cycle's inputs through the planner interface."""
        self.interface.update_planner(predictions, obstacle_xy, obstacle_valid)

    def reach_grid_for(self, predictions):
        """Lanelet-following reach sets of the predicted obstacles' current
        poses, rasterized on the host and uploaded to the planner's device.
        The obstacles' first-step rows come to the host in one copy."""
        first = torch.cat([
            predictions.means[:, 0], predictions.orientations[:, :1],
            predictions.velocities[:, :1], predictions.lengths[:, None],
            predictions.widths[:, None],
            predictions.valid[:, :1].to(predictions.means.dtype),
        ], dim=1).cpu().numpy()
        return build_reach_set_grids(
            self.scenario, first[:, 0:2], first[:, 2], first[:, 3], first[:, 4],
            first[:, 5], first[:, 6] != 0,
            device=self.planner.device, dtype=self.planner.dtype)

    def step(self, predictions, obstacle_xy, obstacle_valid) -> AgentStatus:
        """One simulation step: maybe replan, then execute the next state."""
        if self.pre_step() != AgentStatus.RUNNING:
            return self.status

        if self.needs_replan():
            t0 = time.perf_counter()
            try:
                self.interface.update_planner(predictions, obstacle_xy, obstacle_valid)
                plan = self.interface.step_interface()
            except ValueError as e:
                # the state cannot be projected onto the reference path:
                # this agent fails, the simulation goes on
                self.status = AgentStatus.ERROR
                self.message = f"planner error: {e}"
                return self.status
            self.record.planning_times.append(time.perf_counter() - t0)
            if plan is not None and self.logger is not None:
                self.logger.log_cycle(
                    self.state.time_step, plan, self.planner.infeasible_histogram,
                    self.record.planning_times[-1], self.planner.desired_velocity,
                    cost_weights=self.config.cost_weights,
                )
                if (self.config.debug.save_all_traj
                        and self.planner.last_cycle is not None):
                    res, mat, msk = self.planner.last_cycle
                    self.logger.log_all_candidates(
                        self.state.time_step, res, mat, msk,
                        dt=self.config.planning.dt)
            if plan is None:
                self.status = AgentStatus.ERROR
                self.message = "no feasible trajectory"
                return self.status
            self.current_plan = plan
            self.plan_step = 0

        return self.execute_next_state()

    def execute_next_state(self) -> AgentStatus:
        """Consume the next state of the current plan."""
        self.plan_step += 1
        plan = self.current_plan
        j = min(self.plan_step, len(plan.x) - 1)
        wb = self.veh.wb_rear_axle
        theta = float(plan.theta[j])
        center = np.array([
            plan.x[j] + wb * np.cos(theta),
            plan.y[j] + wb * np.sin(theta),
        ])
        self.state = EgoState(
            time_step=self.state.time_step + 1,
            position=center,
            orientation=theta,
            velocity=float(plan.v[j]),
            acceleration=float(plan.a[j]),
            yaw_rate=((float(plan.theta[j]) - float(plan.theta[j - 1])) / self.dt
                      if j > 0 else 0.0),
            steering_angle=float(np.arctan2(self.veh.wheelbase * plan.kappa[j], 1.0)),
        )
        self.record.states.append(self.state)
        self.x_cl = (
            np.array([plan.s[j], plan.s_dot[j], plan.s_ddot[j]]),
            np.array([plan.d[j], plan.d_dot[j], plan.d_ddot[j]]),
        )
        return self.status

    def set_collision(self):
        self.status = AgentStatus.COLLISION
        self.message = "collision"

    def set_timelimit(self):
        self.status = AgentStatus.TIMELIMIT
        self.message = "time limit reached"
