"""Simulation: scenario + config → stepped agents → result.

PyTorch port of the host loop of `frenetix_tpu/sim/simulation.py`
(`Simulation.run`): per step a global prediction from the same pre-step
snapshot, per agent sensor filtering and the other live agents added as
predicted obstacles (their current plans in ground-truth mode), then the
agents' replanning on the device, and the agent-vs-obstacle, agent-vs-agent
and road-departure checks on the host.

Multi-agent runs (`simulation.start_multiagent`, or a scenario with several
planning problems) step the agents one after the other, or with
`simulation.batched_device_agents` all replanning agents in one device pass
(`parallel.batched_sim.BatchedAgentStepper`) with ONE device→host copy per
densification level.

With `prediction.calc_occlusions` the sensor filter drops obstacles hidden
behind road walls, other obstacles and the other agents' live vehicles
(`sim.visible_area`).  With `occlusion.use_occlusion_module` every agent's
predictions get phantom rows behind the occluders it sees, and its planner
(or the batched cycle) gates and prices the candidates against them; with a
responsibility weight the batched path stacks the agents' reach-set grids.

With `simulation.device_resident_sim` the whole run stays on the device and
the host fetches once (`parallel.device_sim.DeviceSimulation`).

With a `log_dir` and `debug.activate_logging` every agent writes its
trajectory logs under `log_dir/<agent id>`; a `sim_logger`
(`utils.sim_logging.SimulationLogger`) gets the per-step timing rows and the
final results; with `debug.collision_report` every collision writes a JSON
report to `log_dir` (`evaluation.collision_report`).

With `behavior.use_behavior_planner` every agent carries a `BehaviorModule`
(`sim.agent`); with more than one agent each module observes its live peers
through a `sim.world_view.WorldView` instead of their stale recordings.  The
batched path runs the behavior modules on the host before the fused pass; an
agent whose stop point asks for stopping mode goes to the host path that
step, and a reference-path swap rebuilds the stacked tables.

The sharded path, Wale-Net predictions and plotting
(`visualization.save_plots`, `show_plots`) are not ported yet; a config that
asks for them raises NotImplementedError naming the ROADMAP.md
slice that brings them.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from frenetix_tpu_torch import default_device
from frenetix_tpu_torch.evaluation.collision_report import collision_report
from frenetix_tpu_torch.io.commonroad import GoalCondition, PlanningProblem, State
from frenetix_tpu_torch.ops import sampling as smp
from frenetix_tpu_torch.ops.costs import COST_TERM_ORDER
from frenetix_tpu_torch.parallel.mesh import stack_reach_grids
from frenetix_tpu_torch.planner.reactive import PlannedTrajectory, wants_stopping_mode
from frenetix_tpu_torch.risk.reachable_set import build_reach_set_grids
from frenetix_tpu_torch.sim.agent import Agent, AgentStatus
from frenetix_tpu_torch.sim.prediction import (
    constant_velocity_predictions, extrapolate_constant_velocity,
    ground_truth_predictions, to_device,
)
from frenetix_tpu_torch.sim.planner_interfaces import apply_behavior_output
from frenetix_tpu_torch.sim.sensor_model import visible_obstacles
from frenetix_tpu_torch.sim.visible_area import road_boundary_segments
from frenetix_tpu_torch.sim.world_view import attach_world_views
from frenetix_tpu_torch.utils.config import EXTERNAL_COST_KEYS, FrenetixConfig

__all__ = ["Simulation", "SimulationResult"]


def _obb_overlap_np(c1, th1, h1, c2, th2, h2) -> bool:
    """Host scalar separating-axis test of two oriented boxes."""
    axes = []
    for th in (th1, th2):
        c, s = np.cos(th), np.sin(th)
        axes.append(np.array([c, s]))
        axes.append(np.array([-s, c]))
    a1 = [axes[0], axes[1]]
    a2 = [axes[2], axes[3]]
    delta = np.asarray(c2) - np.asarray(c1)
    for ax in axes:
        r1 = h1[0] * abs(ax @ a1[0]) + h1[1] * abs(ax @ a1[1])
        r2 = h2[0] * abs(ax @ a2[0]) + h2[1] * abs(ax @ a2[1])
        if abs(ax @ delta) > r1 + r2:
            return False
    return True


def _unsupported(config: FrenetixConfig, scenario) -> list[str]:
    sim = config.simulation
    out = []
    if sim.sharded_device_agents:
        out.append("simulation.sharded_device_agents (multi-GPU: slice 7)")
    if config.prediction.mode not in ("ground_truth", "constant_velocity"):
        out.append(f"prediction.mode={config.prediction.mode!r} (Wale-Net: slice 5)")
    vis = config.visualization
    for name in ("save_plots", "show_plots"):
        if getattr(vis, name):
            out.append(f"visualization.{name} (plots: slice 8e)")
    return out


@dataclass
class SimulationResult:
    scenario_id: str
    agent_status: dict
    agent_messages: dict
    steps: int
    wall_time: float
    planning_times: list = field(default_factory=list)
    histories: dict = field(default_factory=dict)

    @property
    def success(self) -> bool:
        return all(s == AgentStatus.COMPLETED_SUCCESS for s in self.agent_status.values())


class Simulation:
    def __init__(self, scenario, config: Optional[FrenetixConfig] = None,
                 device: Optional[torch.device] = None, *, msg_logger=None,
                 sim_logger=None, log_dir=None):
        """`device` defaults to the CUDA device (`default_device()`, which
        raises where there is none); pass torch.device("cpu") to run there.
        `msg_logger`, `sim_logger` and `log_dir` as in the JAX package's
        Simulation (there `msg_logger` is the third positional argument)."""
        self.scenario = scenario
        self.config = config or FrenetixConfig()
        self.msg_logger = msg_logger
        self.sim_logger = sim_logger
        self.log_dir = log_dir
        ew = self.config.external_cost_weights
        if (not self.config.occlusion.use_occlusion_module
                and any(float(ew.get(k, 0.0)) != 0.0 for k in EXTERNAL_COST_KEYS)):
            # the soft terms are evaluated only in the occlusion branch: a
            # weight without the module must not be a silent no-op
            raise ValueError(
                "external_cost_weights require occlusion.use_occlusion_module")
        unsupported = _unsupported(self.config, scenario)
        if unsupported:
            raise NotImplementedError(
                "not yet ported to frenetix_tpu_torch: " + "; ".join(unsupported))
        self.device = torch.device(device) if device is not None else default_device()
        self.dtype = torch.float64 if self.config.dtype == "float64" else torch.float32
        self.np_dtype = np.float64 if self.config.dtype == "float64" else np.float32
        self.dt = self.config.planning.dt

        horizon = scenario.max_time_step
        if horizon > 0:
            self.max_steps = int(horizon * self.config.simulation.max_steps_factor)
        else:
            self.max_steps = self.config.simulation.fallback_max_steps

        self.agents: list[Agent] = [
            Agent(pid, pp, scenario, self.config, self.device,
                  msg_logger=msg_logger, log_dir=log_dir)
            for pid, pp in scenario.planning_problems.items()
        ]
        if self.config.simulation.start_multiagent:
            self._create_obstacle_agents()
        self.agent_obstacle_ids = {a.id for a in self.agents}
        if self.config.behavior.use_behavior_planner and len(self.agents) > 1:
            # behavior perception observes the LIVE peers, not the recorded
            # trajectories of the obstacles that became agents
            attach_world_views(self)
        self._peer_rows_cache = None
        self._batched_stepper = None
        self._batched_max_m = 0
        self._road_segments = None      # static wall segments, built at first use
        self._dummy_reach_grid = None

    # ----------------------------------------------------------- multi-agent
    def _create_obstacle_agents(self):
        """Convert dynamic obstacles into planning agents; the goal region is
        an 8 m × 4 m box around the obstacle's final trajectory state."""
        sim_cfg = self.config.simulation
        n_wanted = sim_cfg.number_of_agents
        candidates = self.scenario.dynamic_obstacles
        if sim_cfg.use_specific_agents:
            wanted = set(sim_cfg.agent_ids)
            candidates = [ob for ob in candidates if ob.obstacle_id in wanted]
        elif n_wanted >= 0:
            if sim_cfg.select_agents_randomly and n_wanted < len(candidates):
                # fresh entropy unless agent_selection_seed pins the sample
                rng = np.random.default_rng(sim_cfg.agent_selection_seed)
                pick = sorted(rng.choice(len(candidates), size=n_wanted,
                                         replace=False).tolist())
                candidates = [candidates[i] for i in pick]
            else:
                candidates = candidates[:n_wanted]
        for ob in candidates:
            if ob.obstacle_type not in ("car", "truck", "bus"):
                continue
            if not ob.trajectory:
                continue
            final = ob.trajectory[-1]
            ang = final.orientation
            ca, sa = np.cos(ang), np.sin(ang)
            rot = np.array([[ca, -sa], [sa, ca]])
            half = np.array([[4.0, 2.0], [4.0, -2.0], [-4.0, -2.0], [-4.0, 2.0]])
            goal = GoalCondition(
                position_shape=(half @ rot.T) + final.position,
                time_interval=(0, final.time_step + 20),
                velocity_interval=None,
            )
            init = ob.initial_state
            pp = PlanningProblem(
                problem_id=ob.obstacle_id,
                initial_state=State(
                    time_step=init.time_step, position=init.position,
                    orientation=init.orientation, velocity=init.velocity,
                    acceleration=init.acceleration,
                ),
                goals=[goal],
            )
            try:
                self.agents.append(
                    Agent(ob.obstacle_id, pp, self.scenario, self.config, self.device,
                          msg_logger=self.msg_logger, log_dir=self.log_dir))
            except ValueError as e:
                # no route or reference path for this obstacle: it stays a
                # scenario obstacle and the simulation goes on
                if self.msg_logger:
                    self.msg_logger.warning(f"dropping agent {ob.obstacle_id}: {e}")
                continue

    # ----------------------------------------------------------- predictions
    def _visible_obstacle_ids(self, t: int, exclude: set) -> list[int]:
        ids = [ob.obstacle_id for ob in self.scenario.dynamic_obstacles
               if ob.obstacle_id not in exclude and ob.state_at_time(t) is not None]
        ids += [ob.obstacle_id for ob in self.scenario.static_obstacles
                if ob.obstacle_id not in exclude]
        return ids

    def _predictions_for_step(self, t: int):
        """Global prediction step for time step t (host NumPy fields)."""
        pcfg = self.config.prediction
        ids = self._visible_obstacle_ids(t, self.agent_obstacle_ids)
        if pcfg.mode == "ground_truth":
            pd = ground_truth_predictions(
                self.scenario, ids, t, pcfg.horizon_steps, cov_pos=pcfg.cov_pos,
                max_obstacles=pcfg.max_obstacles, dtype=self.np_dtype,
            )
        else:
            pd = constant_velocity_predictions(
                self.scenario, ids, t, pcfg.horizon_steps, dt=self.dt,
                max_obstacles=pcfg.max_obstacles, dtype=self.np_dtype,
            )
        k = pcfg.uncertainty_margin_sigma
        if k > 0.0:
            # widen the footprint by k · (mean 1σ over the horizon)
            sig = (np.sqrt(np.maximum(pd["covs"][:, :, 0, 0], 0.0))
                   + np.sqrt(np.maximum(pd["covs"][:, :, 1, 1], 0.0)))
            m = k * 0.5 * np.where(pd["valid"].any(axis=1), sig.mean(axis=1), 0.0)
            pd["lengths"] = pd["lengths"] + m.astype(pd["lengths"].dtype)
            pd["widths"] = pd["widths"] + (0.5 * m).astype(pd["widths"].dtype)
        return pd, ids

    def _filter_for_agent(self, pd, ids, agent):
        """Invalidate the prediction rows of obstacles the agent cannot see."""
        pcfg = self.config.prediction
        if not pcfg.use_sensor_model:
            return pd
        if pcfg.calc_occlusions and self._road_segments is None:
            # static geometry: dissolve the lanelet union's boundary once
            self._road_segments = road_boundary_segments(self.scenario)
        vis = set(visible_obstacles(
            self.scenario, agent.id, agent.state, agent.state.time_step,
            sensor_radius=pcfg.sensor_radius,
            occlusions=pcfg.calc_occlusions,
            veh_length=self.config.vehicle.length,
            cone_angle=pcfg.cone_angle,
            cone_safety_dist=pcfg.cone_safety_dist,
            agent_ids=self.agent_obstacle_ids,
            road_segments=self._road_segments,
            extra_occluders=self._live_peer_boxes(agent),
        ))
        for k, oid in enumerate(ids[: pd["valid"].shape[0]]):
            if oid not in vis:
                pd["valid"][k] = False
        return pd

    def _live_peer_boxes(self, agent):
        """(position, orientation, length, width) of the other live agents:
        their vehicles occlude although their scenario trajectories went
        stale when they became agents."""
        veh = self.config.vehicle
        return [
            (a.state.position, a.state.orientation, veh.length, veh.width)
            for a in self.agents
            if a.id != agent.id
            and a.status in (AgentStatus.IDLE, AgentStatus.RUNNING)
        ]

    def _peer_future(self, a: Agent, t: int, horizon: int):
        """The future of one live peer agent as the others see it.

        ground_truth: the remainder of the peer's current plan, converted
          rear axle → center and truncated at the plan's end; before the
          first plan exists (step 0) the converted obstacle's recorded
          trajectory; constant-velocity extrapolation only when neither
          exists (an ego planning problem with no recorded trajectory).
        constant_velocity: extrapolate the current pose.

        Returns (means (H, 2), orientations (H,), velocities (H,), valid (H,),
        cov (2, 2)); invalid tail rows repeat the last valid pose."""
        mode = self.config.prediction.mode
        st = a.state
        means = np.zeros((horizon, 2))
        orient = np.full(horizon, float(st.orientation))
        vel = np.full(horizon, float(st.velocity))
        valid = np.zeros(horizon, bool)
        cov_pos = self.config.prediction.cov_pos

        if mode == "ground_truth":
            plan = a.current_plan
            if plan is not None:
                wb = self.config.vehicle.wb_rear_axle
                n = len(plan.x)
                for i in range(horizon):
                    j = a.plan_step + 1 + i
                    if j >= n:
                        break
                    th = float(plan.theta[j])
                    means[i] = (plan.x[j] + wb * np.cos(th),
                                plan.y[j] + wb * np.sin(th))
                    orient[i] = th
                    vel[i] = float(plan.v[j])
                    valid[i] = True
            else:
                ob = self.scenario.obstacles.get(a.id)
                if ob is not None:
                    for i in range(horizon):
                        s = ob.state_at_time(t + 1 + i)
                        if s is None:
                            break
                        means[i] = s.position
                        orient[i] = float(s.orientation)
                        vel[i] = float(s.velocity)
                        valid[i] = True
            cov = np.eye(2) * cov_pos
            if valid.any():
                n_v = int(valid.sum())
                means[n_v:] = means[n_v - 1]
                orient[n_v:] = orient[n_v - 1]
                vel[n_v:] = vel[n_v - 1]
                return means, orient, vel, valid, cov

        means = extrapolate_constant_velocity(
            st.position, st.orientation, st.velocity, horizon, self.dt)
        valid[:] = True
        cov = np.eye(2) * (cov_pos if mode == "ground_truth" else max(cov_pos, 0.1))
        return means, orient, vel, valid, cov

    def _peer_rows_for_step(self, t: int) -> dict:
        """Every live agent's peer-visible prediction row, computed once per
        step and cached; observers then take all rows but their own."""
        cached = self._peer_rows_cache
        if cached is not None and cached[0] == t:
            return cached[1]
        horizon = self.config.prediction.horizon_steps
        dtype = self.np_dtype
        rows = {}
        for a in self.agents:
            if a.status not in (AgentStatus.IDLE, AgentStatus.RUNNING):
                continue
            means, orient, vel, valid, cov = self._peer_future(a, t, horizon)
            rows[a.id] = dict(
                means=means.astype(dtype),
                orientations=orient.astype(dtype),
                velocities=vel.astype(dtype), valid=valid,
                covs=np.broadcast_to(cov.astype(dtype), (horizon, 2, 2)),
                inv_covs=np.broadcast_to(np.linalg.inv(cov).astype(dtype),
                                         (horizon, 2, 2)))
        self._peer_rows_cache = (t, rows)
        return rows

    def _augment_with_agents(self, pd, for_agent: Agent):
        """The other live agents as predicted obstacles (`_peer_future`).
        Terminated agents are left out: they have left the world.  When the
        fixed tensor width leaves too few free rows, the scenario obstacles
        farthest from the observer are evicted, so that no peer is dropped."""
        others = [
            a for a in self.agents
            if a.id != for_agent.id
            and a.status in (AgentStatus.IDLE, AgentStatus.RUNNING)
        ]
        if not others:
            return pd
        free = list(np.where(~pd["valid"].any(axis=1))[0])
        if len(free) < len(others):
            valid_rows = np.where(pd["valid"].any(axis=1))[0]
            dist = np.linalg.norm(
                pd["means"][valid_rows, 0] - np.asarray(for_agent.state.position)[None],
                axis=1,
            )
            need = len(others) - len(free)
            for row in valid_rows[np.argsort(dist)[::-1][:need]]:
                pd["valid"][row] = False
                free.append(int(row))
        rows = self._peer_rows_for_step(int(for_agent.state.time_step))
        for a, slot in zip(others, free):
            r = rows[a.id]
            pd["means"][slot] = r["means"]
            pd["orientations"][slot] = r["orientations"]
            pd["velocities"][slot] = r["velocities"]
            pd["covs"][slot] = r["covs"]
            pd["inv_covs"][slot] = r["inv_covs"]
            pd["lengths"][slot] = self.config.vehicle.length + 0.5
            pd["widths"][slot] = self.config.vehicle.width + 0.2
            pd["valid"][slot] = r["valid"]
        return pd

    def _agent_predictions(self, pd_base, ids, agent):
        """One agent's predictions: a copy of the global step, sensor-filtered,
        with the other live agents added and, with the occlusion module, the
        phantom rows (which also arms the planner's gate).  The one
        definition shared by the sequential and the batched path.  Returns
        (pd, phantom mask (O,) or None)."""
        pd = {k: v.copy() for k, v in pd_base.items()}
        pd = self._filter_for_agent(pd, ids, agent)
        pd = self._augment_with_agents(pd, agent)
        phantom_mask = None
        if agent.occlusion is not None:
            # as in the sensor path: agents' recorded trajectories are stale,
            # so they are excluded as occluders and their live poses are used
            agent.occlusion.occluder_exclude = frozenset(p.id for p in self.agents)
            agent.occlusion.extra_occluders = tuple(self._live_peer_boxes(agent))
            before = pd["valid"].any(axis=1).copy()
            pd, _ = agent.occlusion.augment_predictions(
                pd, agent.state, agent.state.time_step, self.dt)
            phantom_mask = pd["valid"].any(axis=1) & ~before
            # the host fallbacks (low velocity, batched misses) apply the
            # same gate through the planner; the pose feeds the soft terms
            agent.planner.set_occlusion_module(
                agent.occlusion, phantom_mask, ego_state=agent.state,
                time_step=agent.state.time_step)
        return pd, phantom_mask

    def _reach_grid_from(self, pd, valid=None):
        """Reach-set grids of a host prediction dict's first-step poses, on
        the simulation's device; `valid` overrides the dict's mask."""
        return build_reach_set_grids(
            self.scenario, pd["means"][:, 0], pd["orientations"][:, 0],
            pd["velocities"][:, 0], pd["lengths"], pd["widths"],
            pd["valid"][:, 0] if valid is None else valid,
            device=self.device, dtype=self.dtype)

    def _stacked_reach_grids(self, pd_base, per_pd, batchable):
        """Agent-stacked reach grids for the batched responsibility term:
        real grids only for the agents whose batch rows are consumed; the
        others share one cached all-invalid grid."""
        o_slots = pd_base["valid"].shape[0]
        dummy = self._dummy_reach_grid
        if dummy is None or dummy.occupancy.shape[0] != o_slots:
            dummy = self._reach_grid_from(pd_base, np.zeros(o_slots, bool))
            self._dummy_reach_grid = dummy
        batch_ids = {a.id for a in batchable}
        return stack_reach_grids([
            self._reach_grid_from(per_pd[a.id]) if a.id in batch_ids else dummy
            for a in self.agents])

    def _stacked_occluder_geometry(self, np_dtype):
        """(ego (A, 2), r_vis (A, K), pts (A, Q, 2), pts_valid (A, Q)) for the
        batched occ_um / occ_ve terms: the polar maps and phantom silhouette
        points the sequential planner gathers one agent at a time.  Agents
        without a module keep an open map (r_vis = sensor radius)."""
        a_n = len(self.agents)
        egos = np.zeros((a_n, 2), np_dtype)
        r_all = pts_all = vld_all = None
        for i, a in enumerate(self.agents):
            mod = a.occlusion
            if mod is None:
                continue
            r_vis, ego = mod.polar_map(a.state, a.state.time_step)
            pts, vld = mod.occluder_points()
            if r_all is None:
                r_all = np.full((a_n, len(r_vis)), mod.sensor_radius, np_dtype)
                pts_all = np.zeros((a_n,) + pts.shape, np_dtype)
                vld_all = np.zeros((a_n,) + vld.shape, bool)
            egos[i] = ego
            r_all[i] = r_vis
            pts_all[i] = pts
            vld_all[i] = vld
        return None if r_all is None else (egos, r_all, pts_all, vld_all)

    # ------------------------------------------------------------- collisions
    def _check_collisions(self, t: int):
        """Agent-vs-obstacle and agent-vs-agent OBB checks at step t."""
        veh = self.config.vehicle
        h_agent = (veh.length / 2.0, veh.width / 2.0)
        for a in self.agents:
            if a.status not in (AgentStatus.RUNNING, AgentStatus.IDLE):
                continue
            for ob in self.scenario.obstacles.values():
                if ob.obstacle_id in self.agent_obstacle_ids:
                    continue
                st = ob.state_at_time(t)
                if st is None:
                    continue
                if _obb_overlap_np(
                    a.state.position, a.state.orientation, h_agent,
                    st.position, st.orientation, (ob.length / 2.0, ob.width / 2.0),
                ):
                    a.set_collision()
                    self._write_collision_report(a)
                    break
            if a.status == AgentStatus.COLLISION:
                continue
            for b in self.agents:
                # terminated agents have left the world
                if b.id == a.id or b.status not in (AgentStatus.IDLE,
                                                    AgentStatus.RUNNING):
                    continue
                if _obb_overlap_np(
                    a.state.position, a.state.orientation, h_agent,
                    b.state.position, b.state.orientation, h_agent,
                ):
                    a.set_collision()
                    self._write_collision_report(a)
                    break

    # ---------------------------------------------------------- batched step
    def _step_agents_batched(self, running, pd_base, ids):
        """All replanning agents' cycles in one device pass per sampling
        level; per-agent host work is bookkeeping and executing the selected
        state."""
        active = [a for a in running if a.pre_step() == AgentStatus.RUNNING]
        if not active:
            return

        low_thr = self.config.planning.low_vel_mode_threshold
        replanners = [a for a in active if a.needs_replan()]
        # only replanners consume predictions
        per_pd, phantom_masks = {}, {}
        for a in replanners:
            per_pd[a.id], pm = self._agent_predictions(pd_base, ids, a)
            if pm is not None:
                phantom_masks[a.id] = pm

        # behavior on the host ahead of the fused pass: its velocity feeds
        # the batch; an agent in stopping mode (quintic sampling) takes the
        # host path this step; a reference-path swap makes the stacked
        # tables stale
        stop_thr = self.config.behavior.stopping_mode_threshold
        behavior_v_des, behavior_forced_host = {}, set()
        for a in replanners:
            if a.behavior is None:
                continue
            b_out = a.behavior.execute(None, a.state, a.state.time_step)
            if apply_behavior_output(a, b_out):
                self._batched_stepper = None
            behavior_v_des[a.id] = b_out.desired_velocity
            if wants_stopping_mode(a.planner.stop_point, a.x_cl, stop_thr):
                behavior_forced_host.add(a.id)
        if self._batched_stepper is None:
            from frenetix_tpu_torch.parallel.batched_sim import BatchedAgentStepper

            self._batched_stepper = BatchedAgentStepper(
                self.config, self.agents, self.device)
            self._batched_weights = torch.as_tensor(
                np.array([self.config.cost_weights.get(k, 0.0)
                          for k in COST_TERM_ORDER]),
                dtype=self.dtype, device=self.device)
        stepper = self._batched_stepper
        batchable = [a for a in replanners if a.state.velocity >= low_thr
                     and a.id not in behavior_forced_host]
        host_only = [a for a in replanners if a.state.velocity < low_thr
                     or a.id in behavior_forced_host]

        # the extras of the batched post-passes, the same for every level
        reach_grids = all_phantom_masks = occ_geom = None
        if stepper.resp_weight != 0.0 and batchable:
            reach_grids = self._stacked_reach_grids(pd_base, per_pd, batchable)
        if stepper.use_occlusion and batchable:
            # all-False rows for agents without phantoms this step: the gate
            # then changes nothing for them
            all_phantom_masks = np.zeros(
                (len(self.agents), pd_base["valid"].shape[0]), bool)
            for i, a in enumerate(self.agents):
                if a.id in phantom_masks:
                    all_phantom_masks[i] = phantom_masks[a.id]
            if stepper.use_occ_geom:
                occ_geom = self._stacked_occluder_geometry(self.np_dtype)

        # progressive densification stays batched: agents that miss at one
        # sampling level run again in the next level's batch; only the
        # fallback ladder goes to the host
        pending = list(batchable)
        level = self.config.planning.sampling_min
        a_index = {a.id: i for i, a in enumerate(self.agents)}
        n_agents = len(self.agents)
        while pending and level < self.config.planning.sampling_max:
            t0 = time.perf_counter()
            mats, v_des, x0_th = {}, {}, {}
            max_m = 0
            for a in pending:
                a.ensure_x_cl()
                a.planner.current_velocity = float(a.state.velocity)
                t1, ss1, d1 = a.planner._sampling_ranges(level, a.x_cl)
                m = smp.build_sampling_matrix(
                    t1_vals=t1, ss1_vals=ss1, d1_vals=d1,
                    x0_lon=a.x_cl[0], x0_lat=a.x_cl[1], dtype=self.np_dtype,
                )
                mats[a.id] = m
                v_des[a.id] = behavior_v_des.get(a.id, a.desired_velocity())
                x0_th[a.id] = a.state.orientation
                max_m = max(max_m, len(m))
            bucket = self.config.debug.matrix_bucket
            max_m = ((max_m + bucket - 1) // bucket) * bucket
            # never shrink: the batch keeps one shape over the run
            max_m = max(max_m, self._batched_max_m)
            self._batched_max_m = max_m

            all_mats = np.zeros((n_agents, max_m, 13), self.np_dtype)
            all_masks = np.zeros((n_agents, max_m), bool)
            all_vdes = np.zeros(n_agents, self.np_dtype)
            all_th = np.zeros(n_agents, self.np_dtype)
            pred_list = []
            for i, a in enumerate(self.agents):
                if a.id in mats:
                    m, msk = smp.pad_matrix(mats[a.id], max_m)
                    all_mats[i] = m[:max_m]
                    all_masks[i] = msk[:max_m]
                    all_vdes[i] = v_des[a.id]
                    all_th[i] = x0_th[a.id]
                    pred_list.append(per_pd[a.id])
                else:
                    # an agent that does not replan rides along with harmless
                    # rows and an all-False mask; its `found` comes back False
                    all_mats[i] = all_mats[i - 1] if i else 0.001
                    all_mats[i, :, 1] = 1.0
                    pred_list.append(pd_base)
            preds_stacked = to_device(
                {k: np.stack([pd[k] for pd in pred_list]) for k in pd_base},
                self.device, self.dtype)
            out, poses_all = stepper.step(
                all_mats, all_masks, preds_stacked, all_th, all_vdes,
                self.config.vehicle, self._batched_weights,
                reach_grids=reach_grids, phantom_masks=all_phantom_masks,
                occ_geom=occ_geom,
            )
            # the agents' next poses stay on the device for a caller that
            # rebuilds obstacle tensors there (mesh.agent_pose_predictions)
            self._last_poses_all = poses_all
            out = self._fetch_selection(out)   # the ONE copy of this level
            batch_time = time.perf_counter() - t0
            still_pending = []
            for a in pending:
                i = a_index[a.id]
                # one pass covers the whole batch: record its wall time and
                # size, and the amortised share
                a.record.batch_planning_times.append((batch_time, len(pending)))
                a.record.planning_times.append(batch_time / max(len(pending), 1))
                if out["found"][i]:
                    def g(k):
                        return np.asarray(out[k][i], dtype=self.np_dtype)

                    a.apply_external_plan(PlannedTrajectory(
                        x=g("x"), y=g("y"), theta=g("theta"), v=g("v"),
                        a=g("a"), kappa=g("kappa"), s=g("s"), s_dot=g("s_dot"),
                        s_ddot=g("s_ddot"), d=g("d"), d_dot=g("d_dot"),
                        d_ddot=g("d_ddot"), cost=float(out["cost"][i]),
                        sampling_parameters=all_mats[i, int(out["best"][i])],
                        mode="optimal", cost_terms=g("terms"),
                    ))
                else:
                    still_pending.append(a)
            pending = still_pending
            level += 1
        host_only.extend(pending)   # all levels missed → host fallback ladder

        # host path: low-velocity agents and batched misses
        for a in host_only:
            pd = per_pd[a.id]
            a.current_plan = None
            a.step(to_device(pd, self.device, self.dtype),
                   pd["means"][:, 0], pd["valid"][:, 0])

        # everyone else executes the next planned state
        done_ids = {a.id for a in host_only}
        for a in active:
            if a.id not in done_ids:
                a.execute_next_state()

    @staticmethod
    def _fetch_selection(out: dict) -> dict:
        """The whole selection dict in ONE device→host copy: every field is
        flattened per agent into one (A, L) tensor (indices, counters and
        flags are < 2^24 and survive float32 exactly), copied, and split
        again on the host."""
        dtype = out["x"].dtype
        keys = list(out)
        parts = [out[k].to(dtype).reshape(out[k].shape[0], -1) for k in keys]
        widths = [p.shape[1] for p in parts]
        flat = torch.cat(parts, dim=1).cpu().numpy()
        host, col = {}, 0
        for k, w in zip(keys, widths):
            block = flat[:, col:col + w]
            col += w
            host[k] = block[:, 0] if out[k].dim() == 1 else block
        host["found"] = host["found"] != 0
        host["best"] = host["best"].astype(np.int64)
        return host

    def _check_road_departure(self):
        """An agent whose vehicle center lies outside every lanelet has left
        the road."""
        if not self.config.simulation.check_road_boundary:
            return
        for a in self.agents:
            if a.status != AgentStatus.RUNNING:
                continue
            if not self.scenario.find_lanelets_by_position(a.state.position):
                a.status = AgentStatus.COLLISION
                a.message = "road departure"
                self._write_collision_report(a)

    def _write_collision_report(self, agent):
        if not self.config.debug.collision_report or self.log_dir is None:
            return
        collision_report(agent, self.scenario, self.config.vehicle,
                         log_dir=self.log_dir)

    # -------------------------------------------------------------- main loop
    def run(self) -> SimulationResult:
        if self.config.simulation.device_resident_sim:
            # the whole run on the device, ONE fetch; the adapter gives the
            # host result's shape
            from frenetix_tpu_torch.parallel.device_sim import DeviceSimulation

            ds = DeviceSimulation(self)
            return ds.to_simulation_result(ds.run())
        t_start = time.perf_counter()
        t = 0
        while t < self.max_steps:
            t_step0 = time.perf_counter()
            running = [a for a in self.agents
                       if a.status in (AgentStatus.IDLE, AgentStatus.RUNNING)]
            if not running:
                break
            pd_base, ids = self._predictions_for_step(t)
            if self.config.simulation.batched_device_agents and len(self.agents) > 1:
                self._step_agents_batched(running, pd_base, ids)
            else:
                # every agent's predictions from the SAME pre-step snapshot,
                # before any agent executes (lockstep; it also keeps the
                # sequential and the batched path equal)
                per_pd = {a.id: self._agent_predictions(pd_base, ids, a)[0]
                          for a in running}
                for a in running:
                    pd = per_pd[a.id]
                    a.step(to_device(pd, self.device, self.dtype),
                           pd["means"][:, 0], pd["valid"][:, 0])
            t += 1
            self._check_collisions(t)
            self._check_road_departure()
            if self.sim_logger:
                plan_t = sum(a.record.planning_times[-1] if a.record.planning_times
                             else 0.0 for a in running)
                self.sim_logger.log_global_time(
                    self.scenario.scenario_id, t, time.perf_counter() - t_step0)
                self.sim_logger.log_batch_time(
                    self.scenario.scenario_id, "0", t,
                    time.perf_counter() - t_step0, plan_t)
        for a in self.agents:
            if a.status in (AgentStatus.IDLE, AgentStatus.RUNNING):
                a.set_timelimit()
        if self.sim_logger:
            self.sim_logger.log_results(
                self.scenario.scenario_id, self.agents,
                set(self.scenario.planning_problems.keys()))

        return SimulationResult(
            scenario_id=self.scenario.scenario_id,
            agent_status={a.id: a.status for a in self.agents},
            agent_messages={a.id: a.message for a in self.agents},
            steps=t,
            wall_time=time.perf_counter() - t_start,
            planning_times=[pt for a in self.agents for pt in a.record.planning_times],
            histories={a.id: a.record.states for a in self.agents},
        )
