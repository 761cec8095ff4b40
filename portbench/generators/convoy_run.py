"""The eight-agent convoy as whole simulations: a pool of scenarios drawn
from the seed, each one request of the device-resident run.

Frozen copy (commit a290f9d) of `frenetix_tpu_torch/io/scenario_factory.py`
`make_convoy`, `_traffic` and `_assemble`'s ego and goal, and of
`workloads.device_fleet`'s convoy rule: per scenario the ego's speed is
`ego_v_mps` × U(ego_speed_factor) and the gap between vehicles `gap_m` ×
U(gap_factor), drawn in that order.  The road is one straight lane of
`length_m` with one centerline vertex per metre; the vehicles drive it at
`vehicle_v_mps`, `gap_m`·(i + 1) ahead of the road's start, and their
trajectories are recorded for `recorded_steps` steps.  Plain NumPy; nothing
here imports the program.

A request holds the scenario's raw facts, from which the entry builds the
program's Scenario and the reference works everything out again:

- `ego_position` (2,), `ego_orientation`, `ego_velocity`: the planning
  problem's initial state (vehicle centre);
- `goal_box` (4, 2), `goal_time` (2,), `goal_velocity` (2,): its goal;
- `vehicles` (V, T + 1, 4): every vehicle's recorded centre x, y, heading
  and speed at steps 0 .. T; `vehicle_size` (2,): length and width;
- `lane_width`, `ego_v`, `gap`.
"""
from __future__ import annotations

import numpy as np


def centerline(scenario: dict) -> np.ndarray:
    """(P, 2) the lane's centerline: one vertex per metre along x."""
    n = int(scenario["length_m"])
    return np.stack([np.linspace(0, scenario["length_m"], n), np.zeros(n)], axis=1)


def _pathlength(xy):
    seg = np.linalg.norm(np.diff(xy, axis=0), axis=1)
    return np.concatenate([[0.0], np.cumsum(seg)])


def vehicle_states(center, speed, s_start, dt, n_steps) -> np.ndarray:
    """(n_steps + 1, 4) centre x, y, heading and speed of a vehicle that
    follows the centerline at constant speed from arclength `s_start`
    (`scenario_factory._traffic` with no lane offset)."""
    s_tab = _pathlength(center)
    d = np.gradient(center, axis=0)
    theta_tab = np.unwrap(np.arctan2(d[:, 1], d[:, 0]))
    normal = np.stack([-np.sin(theta_tab), np.cos(theta_tab)], axis=1)
    lane_offset = 0.0
    out = np.zeros((n_steps + 1, 4))
    for t in range(n_steps + 1):
        s = min(s_start + speed * dt * t, s_tab[-1] - 1e-3)
        x = np.interp(s, s_tab, center[:, 0]) + lane_offset * np.interp(
            s, s_tab, normal[:, 0])
        y = np.interp(s, s_tab, center[:, 1]) + lane_offset * np.interp(
            s, s_tab, normal[:, 1])
        th = np.interp(s, s_tab, theta_tab)
        out[t] = (x, y, float(th), float(speed))
    return out


def scenario_request(scenario: dict, ego_v: float, gap: float) -> dict:
    """One convoy scenario's request (see the module's doc)."""
    center = centerline(scenario)
    dt, n_steps = scenario["dt"], scenario["recorded_steps"]
    vehicles = np.stack([
        vehicle_states(center, scenario["vehicle_v_mps"], gap * (i + 1), dt, n_steps)
        for i in range(scenario["n_vehicles"])])
    goal_center = center[int(scenario["goal_frac"] * (len(center) - 1))]
    half = np.array([[5.0, 3.0], [5.0, -3.0], [-5.0, -3.0], [-5.0, 3.0]])
    d0 = center[1] - center[0]
    return {
        "ego_position": center[0] + 0.5 * d0,
        "ego_orientation": float(np.arctan2(d0[1], d0[0])),
        "ego_velocity": float(ego_v),
        "goal_box": half + goal_center,
        "goal_time": np.array([0, n_steps]),
        "goal_velocity": np.array([0.0, ego_v + 6.0]),
        "vehicles": vehicles,
        "vehicle_size": np.array([scenario["vehicle_length_m"],
                                  scenario["vehicle_width_m"]]),
        "lane_width": float(scenario["lane_width_m"]),
        "ego_v": float(ego_v), "gap": float(gap),
    }


def draw_pool(config, mix, seed: int):
    """(lines (1, P, 2): the lane's centerline, the pool's requests)."""
    rng = np.random.default_rng(int(seed))
    sc = config["scenario"]
    pool = []
    for _ in range(mix["pool_requests"]):
        speed = rng.uniform(*mix["ego_speed_factor"])
        gap = rng.uniform(*mix["gap_factor"])
        pool.append(scenario_request(sc, sc["ego_v_mps"] * speed, sc["gap_m"] * gap))
    return centerline(sc)[None], pool
