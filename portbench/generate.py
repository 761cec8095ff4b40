"""The general traffic generator: a configuration and a traffic mix's
parameters → the road and a pool of replanning requests, from the seed.
A configuration that names a `generator` draws its pool with
`generators/<name>.py` instead (`pool_of`).

Everything is plain NumPy.  The road follows `frenetix_tpu_torch/
workloads.py` (commit eab69ff): `dense_cycle_problem`'s 60° arc of radius
150 m and `stacked_cycle_problem`'s copies of it, shifted per agent; the
reach grids follow `stacked_post_pass_extras` (11 reach steps of 64 × 64
cells), their reachable sector drawn per obstacle.

A request holds each agent's Frenet state and the predicted obstacles
around it, padded to the configuration's obstacle slots: ground-truth
predictions that keep their lane offset and speed along the agent's road.
Each agent gets the same candidate count in every request
(`candidates_per_agent`), so every request has the same shapes and the
same work; a state whose sampling ranges would give another count is drawn
again.  A traffic mix (`traffic/<name>.json`) holds:

- `pool_requests`: requests drawn; the window cycles through them in order;
- `agent`: ranges of `s0_m`, `speed_mps`, `d0_m`, `desired_velocity_mps`, and
  `speed_on_grid` (the speed is one of the velocity samples);
- `obstacles`: groups, each with `count`, `ahead_m` (a list of ranges, one
  chosen per obstacle), `lateral_m`, and `speed_mps` or
  `speed_over_agent_mps`; the groups' obstacles fill the slots in order;
- `covariance_m2`, `length_m`, `width_m`: every prediction's;
- `reach_grid` (or null): `steps`, `cells`, `cell_m`, `dt_s`,
  `half_angle_deg`, `margin_m`, `speed_margin_mps`.
"""
from __future__ import annotations

import importlib

import numpy as np

from portbench.reference import road as rr


def _uniform(rng, lo_hi):
    lo, hi = lo_hi
    return float(rng.uniform(lo, hi)) if hi > lo else float(lo)


def centerlines(config) -> np.ndarray:
    """(A, P, 2) raw centerline of every agent's road: the arc, shifted by
    `agent_shift_m` times the agent's index."""
    road = config["road"]
    t = np.linspace(0.0, np.radians(road["arc_deg"]), road["points"])
    r = road["radius_m"]
    arc = np.stack([r * np.sin(t), r * (1.0 - np.cos(t))], axis=1)
    shift = np.asarray(road["agent_shift_m"], np.float64)
    return np.stack([arc + shift * a for a in range(config["agents"])])


def planning_steps(config):
    p = config["planning"]
    return int(round(p["horizon_s"] / p["dt"]))


def sampling_ranges(config, x0_lon, x0_lat, *, time_samples=rr.time_samples,
                    linspace_samples=rr.linspace_samples):
    """(t1, ss1, d1) of one agent, as the planner assembles them: the end
    times with the horizon, the velocities and lateral offsets with the
    current ones.  `velocity.range_mps` is fixed, or absent for the
    planner's rule [max(0.001, v − a_max·H), min(v + a_max/6·H, v_max)]."""
    p, smp, veh = config["planning"], config["sampling"], config["vehicle"]
    n = planning_steps(config)
    t1 = time_samples(p["t_min"], p["horizon_s"], p["dt"], smp["t_level"])
    t1 = np.unique(np.concatenate([t1, [n * p["dt"]]]))
    vel = smp["velocity"]
    if "range_mps" in vel:
        v_lo, v_hi = vel["range_mps"]
    else:
        v = x0_lon[1]
        v_lo = max(0.001, v - veh["a_max"] * p["horizon_s"])
        v_hi = min(v + (veh["a_max"] / 6.0) * p["horizon_s"], veh["v_max"])
    ss1 = np.union1d(linspace_samples(v_lo, v_hi, vel["level"]), [x0_lon[1]])
    lat = smp["lateral"]
    d1 = np.union1d(linspace_samples(*lat["range_m"], lat["level"]), [x0_lat[0]])
    return t1, ss1, d1


def _agent_state(rng, config, mix):
    ag = mix["agent"]
    vel = config["sampling"]["velocity"]
    want = config["candidates_per_agent"]
    for _ in range(100):
        if ag.get("speed_on_grid"):
            grid = rr.linspace_samples(*vel["range_mps"], vel["level"])
            lo, hi = ag["speed_mps"]
            v = float(rng.choice(grid[(grid >= lo) & (grid <= hi)]))
        else:
            v = _uniform(rng, ag["speed_mps"])
        if v < config["planning"]["low_vel_mode_threshold"]:
            raise ValueError(f"speed {v} m/s: the entries plan above the "
                             "low-velocity threshold only")
        x0_lon = (_uniform(rng, ag["s0_m"]), v, 0.0)
        x0_lat = (_uniform(rng, ag["d0_m"]), 0.0, 0.0)
        t1, ss1, d1 = sampling_ranges(config, x0_lon, x0_lat)
        if len(t1) * len(ss1) * len(d1) == want:
            return x0_lon, x0_lat
    raise ValueError(f"no state of {ag} gives {want} candidates")


def _on_road(tab: rr.RefPath, s, d):
    """(x, y, heading) at arclength s and lateral offset d of a road."""
    th = np.interp(s, tab.s, tab.theta)
    x = np.interp(s, tab.s, tab.xy[:, 0]) - d * np.sin(th)
    y = np.interp(s, tab.s, tab.xy[:, 1]) + d * np.cos(th)
    return x, y, th


def _reach_grid(rng, spec, xy, heading, speed):
    """(steps, G, G) occupancy: the cells of a sector ahead of the obstacle
    whose radius grows with its speed plus a margin."""
    g, cell = spec["cells"], spec["cell_m"]
    centers = (np.arange(g) - g / 2.0 + 0.5) * cell
    dx, dy = np.meshgrid(centers, centers, indexing="ij")
    dist = np.hypot(dx, dy)
    bearing = np.abs((np.arctan2(dy, dx) - heading + np.pi) % (2 * np.pi) - np.pi)
    half = np.radians(_uniform(rng, spec["half_angle_deg"]))
    v = speed + _uniform(rng, spec["speed_margin_mps"])
    radius = v * spec["dt_s"] * np.arange(spec["steps"]) + spec["margin_m"]
    return (dist[None] <= radius[:, None, None]) & (bearing[None] <= half)


def draw_pool(config, mix, seed: int):
    """(road centerlines (A, P, 2), list of request dicts of NumPy arrays)."""
    rng = np.random.default_rng(int(seed))
    lines = centerlines(config)
    road = config["road"]
    tabs = [rr.reference_path(c, extension=road["extension_m"]) for c in lines]
    a_n, o_n = config["agents"], config["obstacle_slots"]
    t_n = config["prediction_steps"]
    dt = config["planning"]["dt"]
    spec = mix.get("reach_grid")
    cov = mix["covariance_m2"]
    pool = []
    for _ in range(mix["pool_requests"]):
        req = {k: np.zeros(s, np.float64) for k, s in (
            ("x0_lon", (a_n, 3)), ("x0_lat", (a_n, 3)), ("x0_orientation", (a_n,)),
            ("desired_velocity", (a_n,)), ("means", (a_n, o_n, t_n, 2)),
            ("orientations", (a_n, o_n, t_n)), ("velocities", (a_n, o_n, t_n)),
            ("lengths", (a_n, o_n)), ("widths", (a_n, o_n)))}
        req["valid"] = np.zeros((a_n, o_n, t_n), bool)
        if spec:
            g = spec["cells"]
            req["grid_occupancy"] = np.zeros((a_n, o_n, spec["steps"], g, g), bool)
            req["grid_cell"] = np.full((a_n, o_n), spec["cell_m"])
        for a in range(a_n):
            x0_lon, x0_lat = _agent_state(rng, config, mix)
            req["x0_lon"][a], req["x0_lat"][a] = x0_lon, x0_lat
            req["x0_orientation"][a] = np.interp(x0_lon[0], tabs[a].s, tabs[a].theta)
            req["desired_velocity"][a] = _uniform(rng, mix["agent"]["desired_velocity_mps"])
            slot = 0
            for group in mix["obstacles"]:
                lo, hi = group["count"]
                for _ in range(int(rng.integers(lo, hi + 1))):
                    if slot == o_n:
                        raise ValueError(f"more obstacles than the {o_n} slots")
                    ranges = group["ahead_m"]
                    ahead = _uniform(rng, ranges[int(rng.integers(len(ranges)))])
                    lateral = _uniform(rng, group["lateral_m"])
                    if "speed_mps" in group:
                        speed = _uniform(rng, group["speed_mps"])
                    else:
                        speed = x0_lon[1] + _uniform(rng, group["speed_over_agent_mps"])
                    speed = max(speed, 0.0)
                    s = x0_lon[0] + ahead + speed * dt * np.arange(t_n)
                    x, y, th = _on_road(tabs[a], s, lateral)
                    req["means"][a, slot] = np.stack([x, y], axis=1)
                    req["orientations"][a, slot] = th
                    req["velocities"][a, slot] = speed
                    req["lengths"][a, slot] = mix["length_m"]
                    req["widths"][a, slot] = mix["width_m"]
                    req["valid"][a, slot] = True
                    if spec:
                        req["grid_occupancy"][a, slot] = _reach_grid(
                            rng, spec, (x[0], y[0]), th[0], speed)
                    slot += 1
        eye = np.eye(2)
        req["covs"] = np.broadcast_to(eye * cov, (a_n, o_n, t_n, 2, 2)).copy()
        req["inv_covs"] = np.broadcast_to(eye / cov, (a_n, o_n, t_n, 2, 2)).copy()
        req["desired_avg_velocity"] = req["desired_velocity"].copy()
        req["obstacle_xy"] = req["means"][:, :, 0].copy()
        req["obstacle_valid"] = req["valid"][:, :, 0].copy()
        if spec:
            req["grid_origin"] = req["obstacle_xy"].copy()
            req["grid_valid"] = req["obstacle_valid"].copy()
        pool.append(req)
    return lines, pool


def pool_of(config, mix, seed: int):
    """(lines, pool) of a cell: `generators/<name>.py::draw_pool(config,
    mix, seed)` where the configuration names a `generator`, else
    `draw_pool` above."""
    name = config.get("generator")
    if name is None:
        return draw_pool(config, mix, seed)
    return importlib.import_module(f"portbench.generators.{name}").draw_pool(config, mix, seed)
