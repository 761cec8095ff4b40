"""A scenario fleet per request, resident on the card: the program's
`FleetRunner` over the pool's fleets, one fleet's members stacked along a
scenario axis, its captured cycle replayed once per planning cycle and its
outputs fetched once.

`prepare` builds the program's Scenario, Simulation and DeviceSimulation of
every member of a pool fleet (set-up); the first request gives all the
pool's fleets one lasting runner (`parallel.device_sim.FleetRunner`), so
that one capture serves the whole pool, and freezes the objects set-up
made (`gc.freeze`), as a service does with the state it keeps.  A request
then runs `FleetRunner.run(fleet)`: the fleet's stack (padded and stacked
once, when the runner was made) copied into the shared buffers, the carry
reset, one replay per cycle, one fetch, the host's epilogue per member.

The work counted is each member's own: its agents × its cycles × the
first level's candidates, one program counted, summed over the fleet (as
`entries/device_run.py` counts a convoy, without the fleet's padding).
"""
from __future__ import annotations

import copy
import gc

import numpy as np

from frenetix_tpu_torch.io.commonroad import (
    GoalCondition, Obstacle, PlanningProblem, Scenario, State,
)
from frenetix_tpu_torch.io.scenario_factory import _lanelet_from_center
from frenetix_tpu_torch.parallel.device_sim import DeviceSimulation, FleetRunner
from frenetix_tpu_torch.sim.simulation import Simulation

from portbench.entries.device_run import (
    EGO_ID, FIRST_VEHICLE_ID, LANE_ID, TABLE_COLUMNS, frenetix_config,
)


def build_scenario(member, dt) -> Scenario:
    """The program's Scenario of one member (`generators/fleet_run.py`): its
    lanes, lane k + 1 the same-direction neighbour left of lane k; the
    vehicles' recorded trajectories; the ego's planning problem."""
    length, width = (float(x) for x in member["vehicle_size"])
    obstacles = {}
    for i, states in enumerate(member["vehicles"]):
        recorded = [State(t, np.array([x, y]), float(th), float(v))
                    for t, (x, y, th, v) in enumerate(states)]
        oid = FIRST_VEHICLE_ID + i
        obstacles[oid] = Obstacle(obstacle_id=oid, obstacle_type="car", role="dynamic",
                                  length=length, width=width,
                                  initial_state=recorded[0], trajectory=recorded[1:])
    lanelets = {}
    for k, line in enumerate(member["lanes"]):
        lanelets[LANE_ID + k] = _lanelet_from_center(LANE_ID + k, np.asarray(line),
                                                     member["lane_width"] / 2)
    for k in range(len(lanelets) - 1):
        right, left = lanelets[LANE_ID + k], lanelets[LANE_ID + k + 1]
        right.adj_left, right.adj_left_same_direction = left.lanelet_id, True
        left.adj_right, left.adj_right_same_direction = right.lanelet_id, True
    goal = GoalCondition(position_shape=np.asarray(member["goal_box"]),
                         time_interval=tuple(int(t) for t in member["goal_time"]),
                         velocity_interval=tuple(float(v) for v in member["goal_velocity"]))
    problem = PlanningProblem(
        problem_id=EGO_ID,
        initial_state=State(0, np.asarray(member["ego_position"]),
                            float(member["ego_orientation"]), float(member["ego_velocity"])),
        goals=[goal])
    return Scenario(f"SYN_{member['family'].title()}-1", dt, lanelets, obstacles,
                    {EGO_ID: problem})


class Entry:
    def __init__(self, config, lines, device, tracing=False):
        self.config = config
        self.device = device
        single = frenetix_config(config)
        single.simulation.start_multiagent = False
        multi = copy.deepcopy(single)
        multi.simulation.start_multiagent = True
        self.cfgs = {False: single, True: multi}
        self.fleets = []
        self.runner = None
        self.candidates = None
        self.cycles = 0
        self.k1_shape = None

    def _member(self, member) -> DeviceSimulation:
        dt = self.config["families"][member["family"]]["dt"]
        ds = DeviceSimulation(Simulation(build_scenario(member, dt),
                                         self.cfgs[bool(member["multiagent"])], self.device))
        want = 1 + len(member["vehicles"]) if member["multiagent"] else 1
        if len(ds.agents) != want:
            raise ValueError(f"a {member['family']} member has {len(ds.agents)} agents; "
                             f"its family gives {want}")
        if ds.levels[0][3] != self.config["candidates_per_agent"]:
            raise ValueError(f"{ds.levels[0][3]} candidates per agent, the configuration "
                             f"says {self.config['candidates_per_agent']}")
        return ds

    def prepare(self, req):
        fleet = [self._member(m) for m in req["members"]]
        per_agent = self.config["candidates_per_agent"]
        candidates = sum(len(ds.agents) * ds.n_cycles for ds in fleet) * per_agent
        if self.candidates not in (None, candidates):
            raise ValueError(f"a fleet of {candidates} candidates; the pool's first has "
                             f"{self.candidates}")
        self.candidates = candidates
        self.fleets.append(fleet)
        members = [ds for f in self.fleets for ds in f]
        s_n = max(len(f) for f in self.fleets)
        a_max = max(len(ds.agents) for ds in members)
        rows = max(ds.tensors.ref.s.shape[-1] for ds in members)
        self.cycles = max(ds.n_cycles for ds in members)
        # K1's launch on the stacked (S·A·R, C) table, the queries of one
        # program over every stacked agent row
        n_steps = fleet[0].n_steps
        self.k1_shape = (s_n * a_max * rows, TABLE_COLUMNS,
                         s_n * a_max * per_agent * (n_steps + 1))
        return fleet

    def request(self, fleet):
        if self.runner is None:
            self.runner = FleetRunner(self.fleets)
            # the pool's scenarios live as long as the service: Python's full
            # collections need not walk their objects
            gc.freeze()
        return self.runner.run(fleet)

    def answer(self, results) -> dict:
        """Per member, trimmed to its own agents and cycles, the form of
        `entries/device_run.py`'s answer; `found` every member's (C, A)
        flags flattened and joined."""
        members = [dict(found=np.asarray(r.found), x_cl=r.extras["x_cl_cycles"],
                        sel=r.selections, cost=r.costs, traj=r.trajectories,
                        status_steps=r.status_per_step, status=r.status)
                   for r in results]
        return {"members": members,
                "found": np.concatenate([np.ravel(m["found"]) for m in members])}

    def risk_inputs(self, prepared):
        return None

    def free(self):
        self.runner = None
        self.fleets.clear()
        gc.unfreeze()
