"""A whole multi-agent simulation per request, resident on the card: the
program's `DeviceSimulation` of one pool scenario, its captured cycle
replayed once per planning cycle and its outputs fetched once.

`prepare` builds the program's Scenario, Simulation and DeviceSimulation of
a pool entry (set-up); the first request gives every prepared simulation
one shared runner (`parallel.device_sim.share_runner`), so that one capture
serves the whole pool, and freezes the objects set-up made (`gc.freeze`),
as a service does with the state it keeps.  A request then runs
`DeviceSimulation.run()`: the scenario's inputs into the shared buffers, the
carry reset, one replay per cycle, one fetch, the host's epilogue."""
from __future__ import annotations

import gc

import numpy as np

from frenetix_tpu_torch.io.commonroad import (
    GoalCondition, Obstacle, PlanningProblem, Scenario, State,
)
from frenetix_tpu_torch.io.scenario_factory import _lanelet_from_center
from frenetix_tpu_torch.ops.kinematics import VehicleParams
from frenetix_tpu_torch.parallel.device_sim import DeviceSimulation, share_runner
from frenetix_tpu_torch.sim.simulation import Simulation
from frenetix_tpu_torch.utils.config import load_config

EGO_ID, LANE_ID, FIRST_VEHICLE_ID = 60000, 50000, 100
TABLE_COLUMNS = 7        # K1's columns: θ, κ, κ', x, y and the corridor's two


def frenetix_config(config):
    """The program's configuration: `load_config()`'s defaults with the
    configuration file's sections set over them."""
    cfg = load_config()
    cfg.dtype = config["dtype"]
    for section in ("planning", "prediction", "simulation"):
        for key, value in config[section].items():
            setattr(getattr(cfg, section), key, value)
    cfg.cost_weights = dict(config["cost_weights"])
    cfg.vehicle = VehicleParams(**config["vehicle"])
    return cfg


def build_scenario(config, line, req) -> Scenario:
    """The program's Scenario of one pool request (`generators/convoy_run.py`):
    one lane around the centerline, the vehicles' recorded trajectories, the
    ego's planning problem."""
    dt = config["scenario"]["dt"]
    length, width = (float(x) for x in req["vehicle_size"])
    obstacles = {}
    for i, states in enumerate(req["vehicles"]):
        recorded = [State(t, np.array([x, y]), float(th), float(v))
                    for t, (x, y, th, v) in enumerate(states)]
        oid = FIRST_VEHICLE_ID + i
        obstacles[oid] = Obstacle(obstacle_id=oid, obstacle_type="car", role="dynamic",
                                  length=length, width=width,
                                  initial_state=recorded[0], trajectory=recorded[1:])
    lanelet = _lanelet_from_center(LANE_ID, np.asarray(line), req["lane_width"] / 2)
    goal = GoalCondition(position_shape=np.asarray(req["goal_box"]),
                         time_interval=tuple(int(t) for t in req["goal_time"]),
                         velocity_interval=tuple(float(v) for v in req["goal_velocity"]))
    problem = PlanningProblem(
        problem_id=EGO_ID,
        initial_state=State(0, np.asarray(req["ego_position"]),
                            float(req["ego_orientation"]), float(req["ego_velocity"])),
        goals=[goal])
    return Scenario("SYN_Convoy-1", dt, {LANE_ID: lanelet}, obstacles, {EGO_ID: problem})


class Entry:
    def __init__(self, config, lines, device, tracing=False):
        self.config = config
        self.device = device
        self.line = np.asarray(lines[0])
        self.cfg = frenetix_config(config)
        self.sims = []
        self.shared = False

    def prepare(self, req):
        scenario = build_scenario(self.config, self.line, req)
        ds = DeviceSimulation(Simulation(scenario, self.cfg, self.device))
        if len(ds.agents) != self.config["agents"]:
            raise ValueError(f"{len(ds.agents)} agents, the configuration says "
                             f"{self.config['agents']}")
        first = ds.levels[0][3]
        if first != self.config["candidates_per_agent"]:
            raise ValueError(f"{first} candidates per agent, the configuration says "
                             f"{self.config['candidates_per_agent']}")
        a_n = len(ds.agents)
        self.cycles = ds.n_cycles
        # the first level's real candidates, one program counted (not both
        # kinematics modes): the work the deployment asks for
        self.candidates = ds.n_cycles * a_n * first
        rows = ds.tensors.ref.s.shape[-1]
        self.k1_shape = (a_n * rows, TABLE_COLUMNS, a_n * first * (ds.n_steps + 1))
        self.sims.append(ds)
        return ds

    def request(self, ds):
        if not self.shared:
            share_runner(self.sims)
            self.shared = True
            # the pool's scenarios live as long as the service: Python's full
            # collections need not walk their ~230,000 objects (~0.1 s each)
            gc.freeze()
        return ds.run()

    def answer(self, res) -> dict:
        """Per cycle and agent: `found` (C, A), `x_cl` (C, A, 6) the replan
        state, `sel` (C, A, 3) the pick's (t1, ṡ1, d1), `cost` (C, A) its
        cost; per executed step: `traj` (T, A, 5) centre x, y, θ, v, a and
        `status_steps` (T, A); `status` (A,) the final statuses."""
        return dict(found=np.asarray(res.found), x_cl=res.extras["x_cl_cycles"],
                    sel=res.selections, cost=res.costs, traj=res.trajectories,
                    status_steps=res.status_per_step, status=res.status)

    def risk_inputs(self, prepared):
        return None

    def free(self):
        for ds in self.sims:
            ds._runner = None
        self.sims.clear()
        self.shared = False
        gc.unfreeze()
