"""The plain closed-loop reference of a scenario fleet.

A fleet's answer is its members' answers, each member solved alone by
`reference/run.py`'s closed loop (a fleet pads its members and stacks them
along a scenario axis; none of that changes a member's result).  This
module adds only what the families of `generators/fleet_run.py` need beyond
the one-lane convoy:

- single-agent members (`multiagent` false): the ego is the only agent, and
  every vehicle a scenario obstacle with its ground-truth window
  (`number_of_agents` 0 in `run.setup`);
- curved centerlines: the member's own lane, which `run.setup` smooths and
  scans as it does the convoy's straight one;
- routes and corridors over two same-direction lanelets: each agent's route
  by `frenetix_tpu_torch/planner/route.py`'s rule (the lanelets that hold
  its start, else the nearest centerline; the goal's lanelets, those that
  hold its goal box's mean; a breadth-first search over the same-direction
  neighbours, so the route with the fewest lane changes), the reference
  path from the route's centerline, and the drivable corridor scanned from
  the union of every lanelet's polygon
  (`geometry/corridor.py::corridor_from_polygons` over
  `Scenario.drivable_polygons`).

`setup` is a member's `run.Setup`; `simulate` its free-running closed loop,
whose answer has the form of one member of `entries/fleet_run.py`'s answer;
`simulate_fleet` the fleet's answer over the members asked for.  Nothing
here imports the program or JAX.

Where it departs from the program, besides `reference/run.py`'s departures
(each without effect on the result): every agent of a member must follow
one route, and a route with a lane change is refused (ValueError), since
every route of the four families lies in one lanelet; the lanes carry no
successors, as the families' lanelets have none.
"""
from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np
import torch

from portbench.reference import run


def member_config(config, member) -> dict:
    """The configuration a member runs under: a single-agent member turns no
    vehicle into an agent."""
    sim = dict(config["simulation"])
    if not member["multiagent"]:
        sim["number_of_agents"] = 0
    return dict(config, simulation=sim)


def _holding(rings, point) -> list[int]:
    """The lanelets whose polygon holds `point`."""
    p = np.asarray(point, np.float64)[None]
    return [k for k, ring in enumerate(rings) if run._inside(p, ring)[0]]


def route(lanes, rings, start, goal_center) -> list[int]:
    """The lanelet sequence from `start` to the goal's lanelet with the
    fewest lane changes (neighbour k ± 1 of the same direction), [] where
    the goal lies on no lanelet."""
    starts = _holding(rings, start)
    if not starts:
        starts = [int(np.argmin([np.min(np.linalg.norm(l - np.asarray(start)[None], axis=1))
                                 for l in lanes]))]
    goals = set(_holding(rings, goal_center))
    for first in starts:
        if first in goals:
            return [first]
        prev, queue = {first: None}, deque([first])
        while queue:
            cur = queue.popleft()
            for nb in (cur + 1, cur - 1):
                if not 0 <= nb < len(lanes) or nb in prev:
                    continue
                prev[nb] = cur
                if nb in goals:
                    path = [nb]
                    while prev[path[-1]] is not None:
                        path.append(prev[path[-1]])
                    return path[::-1]
                queue.append(nb)
    return []


def corridor(tab, rings, d_max, d_step):
    """`run.corridor` over the union of `rings`."""
    d = np.arange(-d_max, d_max + d_step / 2, d_step)
    normals = np.stack([-np.sin(tab.theta), np.cos(tab.theta)], axis=1)
    pts = (tab.xy[:, None, :] + d[None, :, None] * normals[:, None, :]).reshape(-1, 2)
    inside = np.zeros(len(pts), bool)
    for ring in rings:
        inside |= run._inside(pts, ring)
    inside = inside.reshape(len(tab.s), len(d))
    zero = int(np.argmin(np.abs(d)))
    out = np.zeros((len(tab.s), 2))
    for i, row in enumerate(inside):
        if not row[zero]:
            continue
        lo, hi = zero, zero
        while lo > 0 and row[lo - 1]:
            lo -= 1
        while hi < len(d) - 1 and row[hi + 1]:
            hi += 1
        out[i] = (d[lo] - d_step / 2, d[hi] + d_step / 2)
    return out


def _starts_and_goals(cfg, member) -> list:
    """Each agent's start and goal box's mean: the ego's, then those of the
    vehicles that become agents (a box around the final recorded state)."""
    vehicles = np.asarray(member["vehicles"], np.float64)
    n_agents = len(vehicles) if cfg["simulation"]["number_of_agents"] < 0 else min(
        cfg["simulation"]["number_of_agents"], len(vehicles))
    out = [(np.asarray(member["ego_position"]), np.asarray(member["goal_box"]).mean(axis=0))]
    for i in range(n_agents):
        final = vehicles[i, -1]
        c, s = np.cos(final[2]), np.sin(final[2])
        ring = run._AGENT_GOAL_HALF @ np.array([[c, -s], [s, c]]).T + final[:2]
        out.append((vehicles[i, 0, :2], ring.mean(axis=0)))
    return out


def setup(config, member) -> run.Setup:
    """A member's facts worked out again (`run.Setup`)."""
    cfg = member_config(config, member)
    lanes = np.asarray(member["lanes"], np.float64)
    half = float(member["lane_width"]) / 2.0
    rings = [run.lane_ring(line, half) for line in lanes]
    routes = {tuple(route(lanes, rings, start, goal))
              for start, goal in _starts_and_goals(cfg, member)}
    if len(routes) != 1 or len(next(iter(routes))) != 1:
        raise ValueError(f"every agent must follow one route within one lanelet: {routes}")
    su = run.setup(cfg, lanes[next(iter(routes))[0]], member)
    if len(lanes) == 1:
        return su
    rd = config["road"]
    return dataclasses.replace(su, corr=corridor(su.tab, rings, rd["corridor_scan_m"],
                                                 rd["corridor_step_m"]), tables={})


def simulate(config, member, *, dtype=torch.float64, device="cpu") -> dict:
    """The free-running closed loop of one member: `run.simulate`'s loop
    over the member's own Setup (`run.simulate` builds its Setup from one
    lane)."""
    su = setup(config, member)
    a_n = len(su.pose0)
    x_cl, pose = su.x_cl0.copy(), np.column_stack([su.pose0, np.zeros(a_n)])
    status = np.full(a_n, run.RUNNING)
    bank, bank_len = su.bank0.copy(), su.bank_len0.copy()
    out = {k: [] for k in ("found", "x_cl", "sel", "cost", "traj", "status_steps")}
    for c in range(su.n_cycles):
        plans, status = run._solve(su, c, dict(x_cl=x_cl, pose=pose, status=status),
                                   dict(bank=bank, bank_len=bank_len), dtype=dtype,
                                   device=device)
        running = status == run.RUNNING
        found = np.array([pl.found for pl in plans])
        std = running & ~found & (pose[:, 3] <= 0.1)
        fb_ok = np.array([pl.fb_ok for pl in plans])
        status = np.where(running & ~found & ~std & ~fb_ok & (c * su.k < su.max_steps),
                          run.ERROR, status)
        out["found"].append(found)
        out["x_cl"].append(x_cl.copy())
        out["sel"].append(np.stack([pl.sel.double().cpu().numpy() for pl in plans]))
        out["cost"].append(np.array([float(pl.cost[pl.idx]) for pl in plans]))
        bank, bank_len = run.bank_of(su, plans, pose, std)
        x_cl, pose, status, traj, steps = run.execute(su, c, plans, x_cl, pose, status, std)
        out["traj"].append(traj)
        out["status_steps"].append(steps)
    res = {k: np.stack(v) for k, v in out.items()}
    res["traj"] = res["traj"].reshape((-1, a_n, 5))[:su.max_steps]
    res["status_steps"] = res["status_steps"].reshape((-1, a_n))[:su.max_steps]
    res["status"] = np.where(status == run.RUNNING, run.TIMELIMIT, status)
    return res


def simulate_fleet(config, request, members, *, dtype=torch.float64, device="cpu") -> dict:
    """A fleet's answer in the entry's form, with the members listed in
    `members` solved alone and the others left out (None)."""
    answers = [None] * len(request["members"])
    for i in members:
        answers[i] = simulate(config, request["members"][i], dtype=dtype, device=device)
    found = [np.ravel(a["found"]) for a in answers if a is not None]
    return {"members": answers, "found": np.concatenate(found) if found else np.zeros(0, bool)}
