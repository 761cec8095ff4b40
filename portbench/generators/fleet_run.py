"""A scenario fleet of four road families as whole simulations: a pool of
fleets drawn from the seed, each one request of the device-resident fleet
run.

Member i of a fleet is of family i mod 4, in the order of the
configuration's `families`: highway, overtake, curve, convoy.  Frozen copy
(commit 101a0b1) of `frenetix_tpu_torch/io/scenario_factory.py`
`make_highway`, `make_overtake`, `make_curve` and `_assemble`'s geometry,
and of `workloads.device_fleet`'s variation rule: per member the speed
factor × U(ego_speed_factor), then the gap factor × U(gap_factor), drawn in
that order from one generator over the pool's fleets in turn.  The factors
act as `device_fleet` applies them:

- highway: ego speed and lead gap; one straight lane of `length_m`, one
  centerline vertex per metre;
- overtake: ego speed and lead gap; two same-direction lanes `lane_width_m`
  apart (lane 0 on the right), the slow lead on the right lane, the ego
  1 m into it heading along x;
- curve: ego speed and the lead's speed; one lane on a left arc of
  `radius_m` over `arc_rad`, max(int(radius · arc), 60) vertices, the lead
  35 m ahead;
- convoy: ego speed and the gap between vehicles (`generators/convoy_run.py`).

Every vehicle follows its lane's centerline at constant speed
(`convoy_run.vehicle_states`, the frozen `_traffic`), recorded for the
family's `recorded_steps`.  Plain NumPy; nothing here imports the program.

A request is one fleet: `members`, a list of member requests, each with the
raw facts of `generators/convoy_run.py` (`ego_position`, `ego_orientation`,
`ego_velocity`, `goal_box`, `goal_time`, `goal_velocity`, `vehicles`,
`vehicle_size`, `lane_width`, `ego_v`, `gap`) and:

- `family`: its family's name;
- `lanes` (L, P, 2): every lane's centerline; lane k + 1 is the
  same-direction neighbour left of lane k;
- `multiagent`: whether every vehicle becomes a planning agent
  (`start_multiagent`), else the vehicles stay scenario obstacles.
"""
from __future__ import annotations

import numpy as np

from portbench.generators import convoy_run

FAMILIES = ("highway", "overtake", "curve", "convoy")
_GOAL_HALF = np.array([[5.0, 3.0], [5.0, -3.0], [-5.0, -3.0], [-5.0, 3.0]])


def _straight(length):
    n = int(length)
    return np.stack([np.linspace(0, length, n), np.zeros(n)], axis=1)


def _member(fam: dict, lanes, vehicles, ego_position, ego_orientation, goal_center,
            goal_half, ego_v, gap) -> dict:
    return {
        "lanes": np.stack(lanes),
        "ego_position": np.asarray(ego_position, np.float64),
        "ego_orientation": float(ego_orientation),
        "ego_velocity": float(ego_v),
        "goal_box": goal_half + goal_center,
        "goal_time": np.array([0, fam["recorded_steps"]]),
        "goal_velocity": np.array([0.0, ego_v + 6.0]),
        "vehicles": np.stack(vehicles),
        "vehicle_size": np.array([fam["vehicle_length_m"], fam["vehicle_width_m"]]),
        "lane_width": float(fam["lane_width_m"]),
        "multiagent": bool(fam["multiagent"]),
        "ego_v": float(ego_v), "gap": float(gap),
    }


def _on_one_lane(fam, center, lead_v, lead_s, ego_v, gap):
    """`_assemble` of one lane: the ego half a vertex into the lane, the goal
    box at `goal_frac` of it."""
    vehicles = [convoy_run.vehicle_states(center, lead_v, lead_s, fam["dt"],
                                          fam["recorded_steps"])]
    d0 = center[1] - center[0]
    goal = center[int(fam["goal_frac"] * (len(center) - 1))]
    return _member(fam, [center], vehicles, center[0] + 0.5 * d0,
                   np.arctan2(d0[1], d0[0]), goal, _GOAL_HALF, ego_v, gap)


def highway(fam, speed, gap) -> dict:
    ego_v, lead_gap = fam["ego_v_mps"] * speed, fam["lead_gap_m"] * gap
    return _on_one_lane(fam, _straight(fam["length_m"]), fam["lead_v_mps"], lead_gap,
                        ego_v, lead_gap)


def curve(fam, speed, gap) -> dict:
    ego_v, lead_v = fam["ego_v_mps"] * speed, fam["lead_v_mps"] * gap
    r, arc = fam["radius_m"], fam["arc_rad"]
    t = np.linspace(0, arc, max(int(r * arc), 60))
    center = np.stack([r * np.sin(t), r * (1 - np.cos(t))], axis=1)
    return _on_one_lane(fam, center, lead_v, fam["lead_s_m"], ego_v, lead_v)


def overtake(fam, speed, gap) -> dict:
    ego_v, lead_gap = fam["ego_v_mps"] * speed, fam["lead_gap_m"] * gap
    right = _straight(fam["length_m"])
    left = right + np.array([0.0, fam["lane_width_m"]])
    vehicles = [convoy_run.vehicle_states(right, fam["lead_v_mps"], lead_gap, fam["dt"],
                                          fam["recorded_steps"])]
    goal = right[int(fam["goal_frac"] * (len(right) - 1))]
    half = np.array([[6.0, 3.2], [6.0, -3.2], [-6.0, -3.2], [-6.0, 3.2]])
    return _member(fam, [right, left], vehicles, right[0] + np.array([1.0, 0.0]), 0.0,
                   goal, half, ego_v, lead_gap)


def convoy(fam, speed, gap) -> dict:
    req = convoy_run.scenario_request(fam, fam["ego_v_mps"] * speed, fam["gap_m"] * gap)
    req.update(lanes=convoy_run.centerline(fam)[None], multiagent=bool(fam["multiagent"]))
    return req


BUILD = {"highway": highway, "overtake": overtake, "curve": curve, "convoy": convoy}


def fleet(config, mix, rng) -> dict:
    """One fleet of `mix["members"]` members by the family rule."""
    members = []
    for i in range(mix["members"]):
        speed = rng.uniform(*mix["ego_speed_factor"])
        gap = rng.uniform(*mix["gap_factor"])
        name = FAMILIES[i % len(FAMILIES)]
        member = BUILD[name](config["families"][name], speed, gap)
        member["family"] = name
        members.append(member)
    return {"members": members}


def draw_pool(config, mix, seed: int):
    """(lines (0, 0, 2): no road is shared, every member carries its lanes;
    the pool's fleets)."""
    rng = np.random.default_rng(int(seed))
    pool = [fleet(config, mix, rng) for _ in range(mix["pool_requests"])]
    return np.zeros((0, 0, 2)), pool
