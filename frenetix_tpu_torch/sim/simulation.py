"""Single-agent simulation: scenario + config → stepped agent → result.

PyTorch port of the sequential host loop of `frenetix_tpu/sim/simulation.py`
(`Simulation.run`): per step a global prediction from the same pre-step
snapshot, sensor filtering, one replanning step of the agent on the device,
then the agent-vs-obstacle and road-departure checks on the host.

Multi-agent runs, the batched and device-resident paths, Wale-Net
predictions, visible-area occlusion and plotting are not ported yet; a
config or scenario that asks for them raises NotImplementedError naming the
ROADMAP.md slice that brings them.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from frenetix_tpu_torch.sim.agent import Agent, AgentStatus
from frenetix_tpu_torch.sim.prediction import (
    constant_velocity_predictions, ground_truth_predictions, to_device,
)
from frenetix_tpu_torch.sim.sensor_model import visible_obstacles
from frenetix_tpu_torch.utils.config import FrenetixConfig

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
    if sim.start_multiagent or len(scenario.planning_problems) != 1:
        out.append("multi-agent simulation (slice 2)")
    if sim.batched_device_agents or sim.sharded_device_agents:
        out.append("batched/sharded agent cycles (slices 2 and 7)")
    if sim.device_resident_sim:
        out.append("simulation.device_resident_sim (slice 6)")
    if config.prediction.mode not in ("ground_truth", "constant_velocity"):
        out.append(f"prediction.mode={config.prediction.mode!r} (Wale-Net: slice 5)")
    if config.prediction.use_sensor_model and config.prediction.calc_occlusions:
        out.append("prediction.calc_occlusions (visible-area occlusion: slice 4)")
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
                 device: torch.device = torch.device("cpu")):
        self.scenario = scenario
        self.config = config or FrenetixConfig()
        unsupported = _unsupported(self.config, scenario)
        if unsupported:
            raise NotImplementedError(
                "not yet ported to frenetix_tpu_torch: " + "; ".join(unsupported))
        self.device = torch.device(device)
        self.dtype = torch.float64 if self.config.dtype == "float64" else torch.float32
        self.np_dtype = np.float64 if self.config.dtype == "float64" else np.float32
        self.dt = self.config.planning.dt

        horizon = scenario.max_time_step
        if horizon > 0:
            self.max_steps = int(horizon * self.config.simulation.max_steps_factor)
        else:
            self.max_steps = self.config.simulation.fallback_max_steps

        self.agents: list[Agent] = [
            Agent(pid, pp, scenario, self.config, self.device)
            for pid, pp in scenario.planning_problems.items()
        ]
        self.agent_obstacle_ids = {a.id for a in self.agents}

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
        vis = set(visible_obstacles(
            self.scenario, agent.id, agent.state, agent.state.time_step,
            sensor_radius=pcfg.sensor_radius,
            veh_length=self.config.vehicle.length,
            cone_angle=pcfg.cone_angle,
            cone_safety_dist=pcfg.cone_safety_dist,
            agent_ids=self.agent_obstacle_ids,
        ))
        for k, oid in enumerate(ids[: pd["valid"].shape[0]]):
            if oid not in vis:
                pd["valid"][k] = False
        return pd

    def _agent_predictions(self, pd_base, ids, agent):
        """One agent's predictions: a copy of the global step, sensor-filtered."""
        pd = {k: v.copy() for k, v in pd_base.items()}
        return self._filter_for_agent(pd, ids, agent)

    # ------------------------------------------------------------- collisions
    def _check_collisions(self, t: int):
        """Agent-vs-obstacle OBB checks at step t."""
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
                    break

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

    # -------------------------------------------------------------- main loop
    def run(self) -> SimulationResult:
        t_start = time.perf_counter()
        t = 0
        while t < self.max_steps:
            running = [a for a in self.agents
                       if a.status in (AgentStatus.IDLE, AgentStatus.RUNNING)]
            if not running:
                break
            pd_base, ids = self._predictions_for_step(t)
            for a in running:
                pd = self._agent_predictions(pd_base, ids, a)
                a.step(to_device(pd, self.device, self.dtype),
                       pd["means"][:, 0], pd["valid"][:, 0])
            t += 1
            self._check_collisions(t)
            self._check_road_departure()
        for a in self.agents:
            if a.status in (AgentStatus.IDLE, AgentStatus.RUNNING):
                a.set_timelimit()

        return SimulationResult(
            scenario_id=self.scenario.scenario_id,
            agent_status={a.id: a.status for a in self.agents},
            agent_messages={a.id: a.message for a in self.agents},
            steps=t,
            wall_time=time.perf_counter() - t_start,
            planning_times=[pt for a in self.agents for pt in a.record.planning_times],
            histories={a.id: a.record.states for a in self.agents},
        )
