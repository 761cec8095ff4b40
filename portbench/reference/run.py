"""The plain closed-loop reference of the device-resident multi-agent run.

What `frenetix_tpu_torch/parallel/device_sim.py::_Runner.step` does each
cycle, as a straightforward loop over agents in PyTorch, in the dtype it is
given (float64 to judge the program, lower for the control), worked out
again from a convoy request of `generators/convoy_run.py`:

- set-up: each agent's reference path from the lane's centerline (a frozen
  copy, commit a290f9d, of `geometry/refpath.py::smooth_polyline` before
  `road.reference_path`), the drivable corridor scanned from the lane's
  polygon (`geometry/corridor.py::corridor_from_polygons`), the agents' first
  curvilinear states (`planner/initial_state.py::compute_initial_state_np`),
  their goals (`Simulation._create_obstacle_agents`, `Agent._compute_goal_s`)
  and the peers' plan bank before the first plan (the converted vehicles'
  recorded states, a constant-velocity pseudo-plan for the ego);
- per cycle: the goal check and the desired velocity at the cycle's start;
  the prediction rows: the scenario obstacles' ground-truth window
  (`sim/prediction.py::ground_truth_predictions`) under the sensor filter
  (radius and rear cone), then one row per agent from the peers' plan bank
  (each observer's own row and the agents that left invalid); per agent and
  sampling level the matrix by the run's rule (`build_sampling_matrices`:
  the end velocities from the pose's speed, the current ṡ and d appended),
  the rollout in the kinematics mode of its speed (below
  `low_vel_mode_threshold` the lateral polynomial over arclength), costs,
  collisions and the corridor (`reference/cycle.py`), the selection, the
  first level that found one winning, else the "stopping" ladder
  (`stopping_rank_key`: lowest end velocity, then end time, then |d − d0|,
  among the feasible candidates); the plans into the bank; then
  `replanning_frequency` executed sub-steps with the status ladder and the
  in-order collision sweep.

`solve_cycle` is one teacher-forced cycle from given states and peers'
plans; `simulate` the free-running closed loop, whose answer has the
entry's form (`entries/device_run.py::Entry.answer`).  Nothing here imports
the program or JAX.

Where it departs from the program (each without effect on the result):
every agent's path is the one lane's centerline (the program routes each
agent, over the one lanelet here); it rolls out only the kinematics mode an
agent's speed selects (the program computes both and merges them); it
drops the window's slots no cycle fills only by never building them; its
emergency ladder knows "stopping" only; the statuses the run's ERROR
transition (no feasible candidate at all) would give are not modelled.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import numpy as np
import torch

from portbench.reference import cycle, road

RUNNING, SUCCESS, TIMELIMIT, COLLISION, ERROR = 1, 2, 3, 4, 5
EPS = 1e-5
ROWS = ("x", "y", "theta_gl", "v", "a", "kappa", "s", "s_vel", "s_acc", "d", "d_vel",
        "d_acc")
_AGENT_GOAL_HALF = np.array([[4.0, 2.0], [4.0, -2.0], [-4.0, -2.0], [-4.0, 2.0]])


# ---------------------------------------------------------------- set-up
def smooth_polyline(xy, point_deviation, step):
    """A smoothing spline through the polyline resampled to `step`, sampled
    at four times its vertices (duplicates dropped)."""
    from scipy.interpolate import splev, splprep

    _, idx = np.unique(xy, axis=0, return_index=True)
    xy = road._resample(xy[np.sort(idx)], step)
    if len(xy) < 4:
        return xy
    tck, u = splprep(xy.T, u=None, k=3, s=len(xy) * point_deviation ** 2)
    x_new, y_new = splev(np.linspace(np.min(u), np.max(u), 4 * len(xy)), tck, der=0)
    out = np.stack([x_new, y_new], axis=1)
    _, idx = np.unique(out, axis=0, return_index=True)
    return out[np.sort(idx)]


def _inside(points, ring):
    """(P,) even-odd test of points in one ring (bounding box first)."""
    a, b = ring, np.roll(ring, -1, axis=0)
    out = np.zeros(len(points), bool)
    box = np.nonzero((points[:, 0] >= a[:, 0].min()) & (points[:, 0] <= a[:, 0].max())
                     & (points[:, 1] >= a[:, 1].min()) & (points[:, 1] <= a[:, 1].max()))[0]
    px, py = points[box, 0], points[box, 1]
    straddles = (a[None, :, 1] > py[:, None]) != (b[None, :, 1] > py[:, None])
    pi, vi = np.nonzero(straddles)
    x_int = a[vi, 0] + (py[pi] - a[vi, 1]) * (b[vi, 0] - a[vi, 0]) / (b[vi, 1] - a[vi, 1])
    crossings = np.bincount(pi[px[pi] < x_int], minlength=len(box))
    out[box] = crossings % 2 == 1
    return out


def corridor(tab: road.RefPath, ring, d_max, d_step):
    """(R, 2) the free interval around d = 0 along every normal of the path,
    sampled every `d_step` up to ±`d_max`, widened by half a step; a vertex
    off the road gets [0, 0]."""
    d = np.arange(-d_max, d_max + d_step / 2, d_step)
    normals = np.stack([-np.sin(tab.theta), np.cos(tab.theta)], axis=1)
    pts = tab.xy[:, None, :] + d[None, :, None] * normals[:, None, :]
    inside = _inside(pts.reshape(-1, 2), ring).reshape(len(tab.s), len(d))
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


def lane_ring(line, half_width):
    """The lane's polygon: left bound, then the right bound reversed."""
    g = np.gradient(line, axis=0)
    th = np.arctan2(g[:, 1], g[:, 0])
    normal = np.stack([-np.sin(th), np.cos(th)], axis=1)
    return np.concatenate([line + half_width * normal, (line - half_width * normal)[::-1]])


@functools.lru_cache(maxsize=4)
def _road(line_bytes, shape, half_width, rd_items):
    rd = dict(rd_items)
    line = np.frombuffer(line_bytes).reshape(shape)
    smoothed = smooth_polyline(line, rd["smooth_point_deviation_m"], rd["smooth_step_m"])
    tab = road.reference_path(smoothed, extension=rd["extension_m"],
                              resample_step=rd["resample_step_m"])
    corr = corridor(tab, lane_ring(line, half_width), rd["corridor_scan_m"],
                    rd["corridor_step_m"])
    return tab, corr


def initial_state(tab: road.RefPath, pose, wheelbase, wb_rear, low_vel):
    """(6,) s, ṡ, s̈, d, ḋ, d̈ of a centre pose (x, y, θ, v, a) with the
    wheels straight (no steering), projected at its rear axle."""
    x, y, th, v, acc = (float(p) for p in pose)
    p = np.array([x - wb_rear * math.cos(th), y - wb_rear * math.sin(th)])
    a_, b_ = tab.xy[:-1], tab.xy[1:]
    ab = b_ - a_
    t = np.clip(np.sum((p[None] - a_) * ab, axis=1)
                / np.maximum(np.sum(ab * ab, axis=1), 1e-12), 0.0, 1.0)
    dist2 = np.sum((p[None] - (a_ + t[:, None] * ab)) ** 2, axis=1)
    i = int(np.argmin(dist2))
    s = float(tab.s[i] + t[i] * (tab.s[i + 1] - tab.s[i]))
    cross = ab[i, 0] * (p[1] - a_[i, 1]) - ab[i, 1] * (p[0] - a_[i, 0])
    d = math.sqrt(dist2[i]) * (1.0 if cross >= 0 else -1.0)
    ds = tab.s[1] - tab.s[0]
    j = int(np.clip(np.floor(s / ds), 0, len(tab.s) - 2))
    lam = s / ds - j
    theta_r, kr, kr_d = (float(c[j] + lam * (c[j + 1] - c[j]))
                         for c in (tab.theta, tab.kappa, tab.kappa_d))
    theta_cl = th - math.fmod(theta_r, 2 * math.pi)
    cos_t, tan_t = math.cos(theta_cl), math.tan(theta_cl)
    one_krd = 1.0 - kr * d
    d_p = one_krd * tan_t
    d_pp = -(kr_d * d + kr * d_p) * tan_t + (one_krd / cos_t ** 2) * (-kr)
    s_vel = v * cos_t / one_krd
    s_acc = (acc - (s_vel ** 2 / cos_t) * (one_krd * tan_t * (-kr)
                                           - (kr_d * d + kr * d_p))) / (one_krd / cos_t)
    if low_vel:
        return np.array([s, s_vel, s_acc, d, d_p, d_pp])
    return np.array([s, s_vel, s_acc, d, v * math.sin(theta_cl),
                     s_acc * d_p + s_vel ** 2 * d_pp])


@dataclass
class Setup:
    """A request's facts worked out again, per agent where an axis is A."""

    config: dict
    tab: road.RefPath
    corr: np.ndarray      # (R, 2) the corridor's bounds
    tables: dict          # (dtype, device) → cycle.Tables
    veh: cycle.Vehicle
    pose0: np.ndarray     # (A, 4) centre x, y, θ, v
    x_cl0: np.ndarray     # (A, 6)
    rings: np.ndarray     # (A, 4, 2) goal boxes
    goal_v: np.ndarray    # (A, 2) goal velocity intervals
    goal_s: np.ndarray    # (A,)
    goal_t: np.ndarray    # (A,) the goal time interval's end
    goal_v_mean: np.ndarray
    bank0: np.ndarray     # (A, W, 4)
    bank_len0: np.ndarray
    others: np.ndarray    # (O, T + 1, 4) the vehicles that are no agent
    other_size: np.ndarray  # (2,) their length and width
    max_steps: int
    n_cycles: int
    k: int
    n_steps: int
    horizon: int

    def table(self, dtype, device):
        key = (dtype, str(device))
        if key not in self.tables:
            cols = np.column_stack([self.tab.theta, self.tab.kappa, self.tab.kappa_d,
                                    self.tab.xy, self.corr])
            self.tables[key] = cycle.Tables(
                s=torch.as_tensor(self.tab.s, dtype=dtype, device=device),
                cols=torch.as_tensor(cols, dtype=dtype, device=device))
        return self.tables[key]


def setup(config, line, req) -> Setup:
    """The Setup of one request over the lane `line` (P, 2)."""
    p, pc, sim = config["planning"], config["prediction"], config["simulation"]
    line = np.ascontiguousarray(line, dtype=np.float64)
    tab, corr = _road(line.tobytes(), line.shape, float(req["lane_width"]) / 2.0,
                      tuple(sorted(config["road"].items())))
    veh = cycle.Vehicle(**config["vehicle"])
    vehicles = np.asarray(req["vehicles"], np.float64)     # (V, T + 1, 4)
    n_agents = len(vehicles) if sim["number_of_agents"] < 0 else min(
        sim["number_of_agents"], len(vehicles))
    recorded = vehicles.shape[1] - 1
    k = int(p["replanning_frequency"])
    max_steps = int(recorded * sim["max_steps_factor"])
    n_steps = int(round(p["planning_horizon"] / p["dt"]))
    horizon = int(pc["horizon_steps"])
    w_bank = max(n_steps + 1, horizon + 1)
    ego = np.array([*req["ego_position"], req["ego_orientation"], req["ego_velocity"]])
    pose0 = np.stack([ego] + [vehicles[i, 0] for i in range(n_agents)])
    thr = p["low_vel_mode_threshold"]
    x_cl0 = np.stack([initial_state(tab, (*q, 0.0), veh.wheelbase, veh.wb_rear_axle,
                                    q[3] < thr) for q in pose0])
    rings, goal_v, goal_t, goal_v_mean = [np.asarray(req["goal_box"], float)], \
        [np.asarray(req["goal_velocity"], float)], [float(req["goal_time"][1])], \
        [max(0.0, float(np.mean(req["goal_velocity"])))]
    bank0 = np.zeros((1 + n_agents, w_bank, 4))
    steps = np.arange(w_bank)
    x, y, th, v = ego
    bank0[0] = np.stack([x + v * p["dt"] * steps * math.cos(th),
                         y + v * p["dt"] * steps * math.sin(th),
                         np.full(w_bank, th), np.full(w_bank, v)], axis=1)
    bank_len0 = np.full(1 + n_agents, w_bank, np.int64)
    for i in range(n_agents):
        final = vehicles[i, -1]
        c, s = math.cos(final[2]), math.sin(final[2])
        rings.append(_AGENT_GOAL_HALF @ np.array([[c, -s], [s, c]]).T + final[:2])
        goal_v.append(np.array([-1e30, 1e30]))
        goal_t.append(float(recorded + 20))
        goal_v_mean.append(0.0)
        n_rec = min(w_bank, recorded + 1)
        bank0[1 + i, :n_rec] = vehicles[i, :n_rec]
        bank0[1 + i, n_rec:] = vehicles[i, n_rec - 1]
        bank_len0[1 + i] = n_rec
    rings = np.stack(rings)
    goal_s = np.array([tab.s[int(np.argmin(np.linalg.norm(tab.xy - r.mean(axis=0), axis=1)))]
                       for r in rings])
    return Setup(config=config, tab=tab, corr=corr, tables={}, veh=veh, pose0=pose0, x_cl0=x_cl0,
                 rings=rings, goal_v=np.stack(goal_v), goal_s=goal_s,
                 goal_t=np.array(goal_t), goal_v_mean=np.array(goal_v_mean),
                 bank0=bank0, bank_len0=bank_len0, others=vehicles[n_agents:],
                 other_size=np.asarray(req["vehicle_size"], float), max_steps=max_steps,
                 n_cycles=-(-max_steps // k), k=k, n_steps=n_steps, horizon=horizon)


# ------------------------------------------------------------ per cycle
def goal_reached(su: Setup, center, v):
    """(A,) inside the goal box (crossing number) with the speed in its
    interval; `center` (A, 2), `v` (A,) as NumPy."""
    a, b = su.rings, np.roll(su.rings, -1, axis=1)               # (A, 4, 2)
    p = np.asarray(center, np.float64)[:, None, :]
    cond = (a[..., 1] > p[..., 1]) != (b[..., 1] > p[..., 1])
    den = b[..., 1] - a[..., 1]
    den = np.where(den == 0.0, 1.0, den)
    x_int = a[..., 0] + (p[..., 1] - a[..., 1]) * (b[..., 0] - a[..., 0]) / den
    inside = np.sum(cond & (p[..., 0] < x_int), axis=-1) % 2 == 1
    v = np.asarray(v, np.float64)
    return inside & (v >= su.goal_v[:, 0]) & (v <= su.goal_v[:, 1])


def desired_velocity(su: Setup, x_cl, v, t):
    """(A,) the simulation's velocity planner at global step `t`."""
    dist = su.goal_s - x_cl[:, 0]
    remaining = (su.goal_t - t) * su.config["planning"]["dt"]
    safe = np.where(remaining == 0.0, 1.0, remaining)
    out = np.clip(dist / safe, np.maximum(v - 5.0, 0.0), v + 5.0)
    out = np.where(remaining <= 0.0, np.maximum(v, 1.0), out)
    return np.where(dist <= 2.0, su.goal_v_mean, out)


def _enrich_orientation(means, fallback):
    out, prev = np.full(len(means), fallback), fallback
    for i in range(1, len(means)):
        dx, dy = means[i] - means[i - 1]
        if dx * dx + dy * dy > 1e-8:
            prev = math.atan2(dy, dx)
        out[i] = prev
    out[0] = out[1] if len(means) > 1 else fallback
    return out


def window_rows(su: Setup, t, center, theta):
    """Per observer, the scenario obstacles' ground-truth rows at step `t`
    (NumPy dicts, rows in the obstacles' order), with the sensor filter."""
    pc, veh = su.config["prediction"], su.veh
    h, recorded = su.horizon, su.others.shape[1] - 1
    present = [o for o in range(len(su.others)) if t <= recorded][:pc["max_obstacles"]]
    o_n = len(present)
    means = np.zeros((o_n, h, 2))
    vel = np.zeros((o_n, h))
    valid = np.zeros((o_n, h), bool)
    orient = np.zeros((o_n, h))
    for r, o in enumerate(present):
        n = max(0, min(h, recorded - t))
        means[r, :n] = su.others[o, t + 1:t + 1 + n, :2]
        vel[r, :n] = su.others[o, t + 1:t + 1 + n, 3]
        valid[r, :n] = True
        if n:
            means[r, n:] = means[r, n - 1]
            vel[r, n:] = vel[r, n - 1]
            orient[r] = _enrich_orientation(means[r], su.others[o, t, 2])
    out = []
    for a in range(len(center)):
        ok = np.ones(o_n, bool)
        if pc["use_sensor_model"]:
            for r, o in enumerate(present):
                rel = su.others[o, t, :2] - center[a]
                c, s = math.cos(-theta[a]), math.sin(-theta[a])
                loc_x = c * rel[0] - s * rel[1] - veh.length / 2.0
                loc_y = s * rel[0] + c * rel[1]
                dist = math.hypot(loc_x, loc_y)
                behind = (loc_x < 0 and dist > pc["cone_safety_dist"]
                          and abs(abs(math.atan2(loc_y, loc_x)) - math.pi)
                          < pc["cone_angle"] * math.pi / 180.0 / 2.0)
                ok[r] = np.linalg.norm(rel) < pc["sensor_radius"] and not behind
        out.append(dict(means=means, vel=vel, orient=orient, valid=valid & ok[:, None],
                        length=su.other_size[0] + 0.5, width=su.other_size[1] + 0.2))
    return out


def peer_rows(su: Setup, bank, bank_len, offset, active):
    """(A, T) indices into every agent's bank, and their validity."""
    idx = offset + np.arange(su.horizon)
    clamped = np.clip(np.minimum(idx[None, :], bank_len[:, None] - 1), 0, None)
    rows = np.take_along_axis(bank, clamped[..., None], axis=1)   # (A, T, 4)
    return rows, (idx[None, :] < bank_len[:, None]) & active[:, None]


def predictions(su: Setup, a, window, peers, dtype, device) -> cycle.Preds:
    """Observer `a`'s rows: the window's, then every agent's but its own."""
    rows, in_plan = peers
    cov = su.config["prediction"]["cov_pos"]
    veh = su.veh
    own = np.arange(len(rows)) == a
    means = np.concatenate([window["means"], rows[..., :2]])
    orient = np.concatenate([window["orient"], rows[..., 2]])
    vel = np.concatenate([window["vel"], rows[..., 3]])
    valid = np.concatenate([window["valid"], in_plan & ~own[:, None]])
    o_n = len(means)
    lengths = np.r_[np.full(len(window["means"]), window["length"]),
                    np.full(len(rows), veh.length + 0.5)]
    widths = np.r_[np.full(len(window["means"]), window["width"]),
                   np.full(len(rows), veh.width + 0.2)]
    eye = np.broadcast_to(np.eye(2), (o_n, su.horizon, 2, 2))

    def t(x, dt=dtype):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dt, device=device)

    return cycle.Preds(means=t(means), inv_covs=t(eye / cov), covs=t(eye * cov),
                       orientations=t(orient), velocities=t(vel), lengths=t(lengths),
                       widths=t(widths), valid=t(valid, torch.bool))


def _linspace64(lo, hi, n):
    grid = np.arange(n) * ((hi - lo) / (n - 1)) + lo
    grid[-1] = hi
    return grid


def levels(config):
    """[(end times, velocity samples, lateral samples)] per sampling level."""
    p = config["planning"]
    n_steps = int(round(p["planning_horizon"] / p["dt"]))
    out = []
    for level in range(p["sampling_min"], max(p["sampling_max"], p["sampling_min"] + 1)):
        t1 = road.time_samples(p["t_min"], p["planning_horizon"], p["dt"], level)
        t1 = np.unique(np.concatenate([t1, [n_steps * p["dt"]]]))
        out.append((t1, len(road.linspace_samples(0.0, 1.0, level)),
                    len(road.linspace_samples(p["d_min"], p["d_max"], level))))
    return out


def sampling_matrix(config, level, x_cl, v, dtype, device):
    """(M, 13) one agent's matrix by the run's rule: end velocities on
    [max(0.001, v − a_max·H), min(v + a_max/6·H, v_max)] from the pose's
    speed and lateral offsets on [d_min, d_max] (around d0 with d_ego_pos),
    each grid in float64 and cast once, the current ṡ and d appended; d
    fastest, then ṡ, then t."""
    p, veh = config["planning"], config["vehicle"]
    t1, n_v, n_d = level
    cast = torch.as_tensor(np.asarray(x_cl, np.float64), dtype=dtype)
    s0, ss0, sss0, d0, dd0, ddd0 = (cast[i] for i in range(6))
    h = p["planning_horizon"]
    v64 = float(v)
    vs = torch.cat([torch.as_tensor(_linspace64(max(v64 - veh["a_max"] * h, 0.001),
                                                min(v64 + veh["a_max"] / 6.0 * h,
                                                    veh["v_max"]), n_v), dtype=dtype),
                    ss0[None]])
    if p["d_ego_pos"]:
        lo, hi = float(d0 + p["d_min"]), float(d0 + p["d_max"])
    else:
        lo, hi = p["d_min"], p["d_max"]
    ds = torch.cat([torch.as_tensor(_linspace64(lo, hi, n_d), dtype=dtype), d0[None]])
    tg = torch.as_tensor(t1, dtype=dtype)
    tt, vv, dd = torch.meshgrid(tg, vs, ds, indexing="ij")
    m = tt.numel()
    zero = torch.zeros(m, dtype=dtype)
    mat = torch.stack([zero, tt.reshape(-1), s0.expand(m), ss0.expand(m), sss0.expand(m),
                       vv.reshape(-1), zero, d0.expand(m), dd0.expand(m), ddd0.expand(m),
                       dd.reshape(-1), zero, zero], dim=-1)
    return mat.to(device)


def rollout(matrix, tab, veh, x0_orientation, *, dt, n_steps, window, low_vel):
    """`cycle.rollout`, and in low-velocity mode its twin with the lateral
    polynomial over arclength (d′ and d″ are then the lateral rates
    themselves, the heading follows the path at every step)."""
    if not low_vel:
        return cycle.rollout(matrix, tab, veh, x0_orientation, dt=dt, n_steps=n_steps,
                             window=window)
    dtype, device = matrix.dtype, matrix.device
    m, n1 = matrix.shape[0], n_steps + 1
    t1 = matrix[:, 1]
    s0, ss0, sss0, ss1 = matrix[:, 2], matrix[:, 3], matrix[:, 4], matrix[:, 5]
    c_lon = cycle.quartic(s0, ss0, sss0, ss1, t1)
    tgrid = torch.arange(n1, dtype=dtype, device=device) * dt
    traj_len = torch.clamp(torch.round(t1 / dt).long() + 1, 2, n1)
    t_end = (traj_len - 1).to(dtype) * dt
    inside = tgrid < traj_len[:, None].to(dtype) * dt
    tau = torch.minimum(tgrid, t_end[:, None])
    s_end = cycle.position(c_lon, t_end[:, None])[:, 0]
    v_end = cycle.velocity(c_lon, t_end[:, None])[:, 0]
    s = torch.where(inside, cycle.position(c_lon, tau),
                    s_end[:, None] + (tgrid - t_end[:, None]) * v_end[:, None])
    s_vel = torch.where(inside, cycle.velocity(c_lon, tau), v_end[:, None])
    sa = cycle.acceleration(c_lon, tau)
    s_acc = torch.where(inside, sa, torch.zeros_like(sa))
    span = s_end - s0
    lat_t = torch.where(span > 0.0, span, t1)
    tau_lat = torch.where(inside, s - s0[:, None], span[:, None])
    c_lat = cycle.quintic(matrix[:, 7], matrix[:, 8], matrix[:, 9], matrix[:, 10],
                          matrix[:, 11], matrix[:, 12], lat_t)
    zero = torch.zeros((), dtype=dtype, device=device)
    d = cycle.position(c_lat, tau_lat)
    dp = torch.where(inside, cycle.velocity(c_lat, tau_lat), zero)
    dpp = torch.where(inside, cycle.acceleration(c_lat, tau_lat), zero)
    slot = torch.zeros((m, 11), dtype=torch.bool, device=device)
    neg = torch.any(s_vel < -EPS, dim=-1)
    slot[:, 10] = slot[:, 2] = neg
    slot[:, 1] = torch.any(torch.abs(s_acc) > veh.a_max, dim=-1)
    s_vel = torch.where(torch.abs(s_vel) < EPS, zero, s_vel)
    cols, in_dom = cycle._lookup(tab, s, s0[0], window)
    theta_lerp, k_r, k_r_d = cols[..., 0], cols[..., 1], cols[..., 2]
    alpha = torch.fmod(theta_lerp, cycle.TWO_PI)
    slot[:, 3] = torch.any(~in_dom, dim=-1)
    theta_cl = torch.atan2(dp, torch.ones_like(dp))
    theta_gl = theta_cl + alpha
    one_krd = 1.0 - k_r * d
    cos_t, tan_t = torch.cos(theta_cl), torch.tan(theta_cl)
    ratio = cos_t / one_krd
    kappa = (dpp + (k_r * dp + k_r_d * d) * tan_t) * cos_t * ratio * ratio + ratio * k_r
    v = s_vel * (one_krd / cos_t)
    a = s_acc * (one_krd / cos_t) + (s_vel * s_vel / cos_t) * (
        one_krd * tan_t * (kappa * (one_krd / cos_t) - k_r) - (k_r_d * d + k_r * dp))
    kappa_max = math.tan(veh.delta_max) / veh.wheelbase
    slot[:, 4] = torch.any(v < -EPS, dim=-1)
    slot[:, 5] = torch.any(torch.abs(kappa) > kappa_max, dim=-1)
    zcol = torch.zeros((m, 1), dtype=dtype, device=device)
    yaw_rate = torch.round(torch.cat([zcol, torch.diff(theta_gl, dim=-1) / dt], -1) * 1e5) / 1e5
    slot[:, 6] = torch.any(torch.abs(yaw_rate) > kappa_max * v, dim=-1)
    kappa_rate = torch.cat([zcol, torch.diff(kappa, dim=-1) / dt], dim=-1)
    slot[:, 7] = torch.any(torch.abs(kappa_rate) > veh.kappa_dot_max, dim=-1)
    one = torch.ones((), dtype=dtype, device=device)
    fast = v > veh.v_switch
    a_lim = torch.where(fast, veh.a_max * veh.v_switch / torch.where(fast, v, one),
                        torch.full_like(v, veh.a_max))
    slot[:, 8] = torch.any((a < -veh.a_max) | (a > a_lim), dim=-1)
    x = cols[..., 3] - d * torch.sin(theta_lerp)
    y = cols[..., 4] + d * torch.cos(theta_lerp)
    slot[:, 9] = torch.any(~in_dom, dim=-1)
    feasible = ~torch.any(slot[:, 1:9], dim=-1)
    valid = ~(slot[:, 10] | slot[:, 9])
    slot[:, 0] = ~(feasible & valid)
    return dict(s=s, s_vel=s_vel, s_acc=s_acc, d=d, d_vel=dp, d_acc=dpp, x=x, y=y,
                theta_gl=theta_gl, theta_cl=theta_cl, v=v, a=a, kappa=kappa,
                d_lo=cols[..., 5], d_hi=cols[..., 6], c_lon=c_lon, c_lat=c_lat,
                feasible=feasible, valid=valid, slots=slot)


def _rank(col):
    return torch.searchsorted(torch.sort(col).values, col.contiguous())


def stopping_order(matrix, d0):
    """The "stopping" ladder's key: (rank(ṡ1)·M + rank(t1))·M + rank(|d1 − d0|)."""
    m = matrix.shape[0]
    col = matrix.double()
    return (_rank(col[:, 5]) * m + _rank(col[:, 1])) * m \
        + _rank(torch.abs(col[:, 10] - float(d0)))


@dataclass
class Plan:
    """One agent's cycle: the selected candidate and what it was chosen from."""

    matrix: torch.Tensor     # (M, 13)
    ro: dict
    cost: torch.Tensor       # (M,)
    selectable: torch.Tensor
    feasible: torch.Tensor   # feasible ∧ valid: the ladder's candidates
    found: bool
    fb_ok: bool
    idx: int                 # the pick: the best, or the ladder's

    def rows(self, idx=None):
        """Candidate `idx`'s state rows (12, N+1) in `ROWS` order (the
        pick's by default)."""
        return torch.stack([self.ro[k][self.idx if idx is None else idx] for k in ROWS])

    @property
    def sel(self):
        return self.matrix[self.idx, [1, 5, 10]]


def plan_agent(su: Setup, config, x_cl, v, theta, preds, v_des, dtype, device) -> Plan:
    """One agent's selection over the sampling levels."""
    p = config["planning"]
    tab = su.table(dtype, device)
    low_vel = float(v) < p["low_vel_mode_threshold"]
    plan = None
    for level in levels(config):
        matrix = sampling_matrix(config, level, x_cl, v, dtype, device)
        ro = rollout(matrix, tab, su.veh, float(theta), dt=p["dt"], n_steps=su.n_steps,
                     window=config["road"]["table_window"], low_vel=low_vel)
        cost = cycle.cost_terms(ro, preds, dt=p["dt"], desired_velocity=float(v_des),
                                weights=config["cost_weights"])
        feas = ro["feasible"] & ro["valid"]
        selectable = feas & ~cycle.collides(ro, preds, su.veh) & ~cycle.off_road(ro, su.veh)
        best, found = cycle.select(cost, selectable)
        key = torch.where(feas, stopping_order(matrix, x_cl[3]),
                          torch.full((len(feas),), torch.iinfo(torch.int64).max,
                                     device=feas.device))
        idx = int(best) if bool(found) else int(torch.argmin(key))
        plan = Plan(matrix, ro, cost, selectable, feas, bool(found), bool(feas.any()), idx)
        if plan.found:
            break
    return plan


def solve_cycle(config, request, c, states, plans, *, lines, dtype=torch.float64,
                device="cpu"):
    """One teacher-forced cycle `c` of every agent.

    `states`: the agents' state at the cycle's start, before its goal check,
    as NumPy: `x_cl` (A, 6), `pose` (A, 5) centre x, y, θ, v, a, `status`
    (A,); `plans`: the peers' plan bank `bank` (A, W, 4) and `bank_len` (A,)
    as the cycle reads it.  Returns (per-agent Plans, statuses after the
    goal check)."""
    return _solve(setup(config, lines[0], request), c, states, plans, dtype=dtype,
                  device=device)


def _solve(su: Setup, c, states, plans, *, dtype, device):
    config = su.config
    x_cl, pose = np.asarray(states["x_cl"], np.float64), np.asarray(states["pose"], float)
    status = np.array(states["status"])
    t0 = c * su.k
    running_pre = status == RUNNING
    reached = goal_reached(su, pose[:, :2], pose[:, 3]) & running_pre & (t0 < su.max_steps)
    status = np.where(reached, SUCCESS, status)
    v_des = desired_velocity(su, x_cl, pose[:, 3], t0)
    window = window_rows(su, t0, pose[:, :2], pose[:, 2])
    peers = peer_rows(su, np.asarray(plans["bank"], float),
                      np.asarray(plans["bank_len"]), 1 if c == 0 else su.k + 1, running_pre)
    out = [plan_agent(su, config, x_cl[a], pose[a, 3], pose[a, 2],
                      predictions(su, a, window[a], peers, dtype, device),
                      v_des[a], dtype, device) for a in range(len(x_cl))]
    return out, status


def bank_of(su: Setup, plans, pose, std):
    """The bank the agents publish: each pick's centre x, y, θ, v, or a
    standstill agent's pose at v = 0; padded with the last row."""
    wb = su.veh.wb_rear_axle
    w = su.bank0.shape[1]
    bank = np.zeros((len(plans), w, 4))
    for a, pl in enumerate(plans):
        r = pl.rows().double().cpu().numpy()
        x, y, th, v = r[0], r[1], r[2], r[3]
        rows = np.stack([x + wb * np.cos(th), y + wb * np.sin(th), th, v], axis=1)
        rows = np.concatenate([rows, np.repeat(rows[-1:], max(0, w - len(rows)), 0)])[:w]
        bank[a] = np.tile([*pose[a, :2], pose[a, 2], 0.0], (w, 1)) if std[a] else rows
    return bank, np.full(len(plans), su.n_steps + 1, np.int64)


def obb_overlap(ca, ta, ha, cb, tb, hb):
    """Boxes (centre, heading, half sizes) overlap: no separating axis among
    the four edge normals (NumPy, broadcasting)."""
    dx, dy = cb[..., 0] - ca[..., 0], cb[..., 1] - ca[..., 1]
    ac, as_, bc, bs = np.cos(ta), np.sin(ta), np.cos(tb), np.sin(tb)
    al, aw, bl, bw = ha[..., 0], ha[..., 1], hb[..., 0], hb[..., 1]
    cd, sd = np.abs(ac * bc + as_ * bs), np.abs(as_ * bc - ac * bs)
    return ~((np.abs(dx * ac + dy * as_) > al + bl * cd + bw * sd)
             | (np.abs(dy * ac - dx * as_) > aw + bl * sd + bw * cd)
             | (np.abs(dx * bc + dy * bs) > bl + al * cd + aw * sd)
             | (np.abs(dy * bc - dx * bs) > bw + al * sd + aw * cd))


def collision_step(su: Setup, t, center, theta, step_ok):
    """(A,) bool: the agents marked colliding at step t, in order: each
    against the obstacles and the moving agents not marked before it."""
    half = np.array([su.veh.length / 2.0, su.veh.width / 2.0])
    a_n = len(center)
    hit_obs = np.zeros(a_n, bool)
    if len(su.others) and t <= su.others.shape[1] - 1:
        o = su.others[:, t]
        hit_obs = obb_overlap(center[:, None], theta[:, None], half, o[None, :, :2],
                              o[None, :, 2], su.other_size / 2.0).any(axis=1)
    pair = obb_overlap(center[:, None], theta[:, None], half, center[None], theta[None],
                       half) & ~np.eye(a_n, dtype=bool)
    marked = np.zeros(a_n, bool)
    for i in range(a_n):
        marked[i] = step_ok[i] and (hit_obs[i] or bool(np.any(pair[i] & step_ok & ~marked)))
    return marked


def execute(su: Setup, c, plans, x_cl, pose, status, std):
    """The k sub-steps of cycle c: returns the new (x_cl, pose, status) and
    per sub-step the poses (k, A, 5) and statuses (k, A)."""
    wb = su.veh.wb_rear_axle
    x_cl, pose, status = x_cl.copy(), pose.copy(), status.copy()
    rows = [pl.rows().double().cpu().numpy() for pl in plans]          # (12, N+1)
    traj, steps = [], []
    for j in range(1, su.k + 1):
        t = c * su.k + j
        running = status == RUNNING
        if j > 1:
            reached = goal_reached(su, pose[:, :2], pose[:, 3]) & running & (t <= su.max_steps)
            status = np.where(reached, SUCCESS, status)
            running = status == RUNNING
        step_ok = running & (t <= su.max_steps)
        for a, r in enumerate(rows):
            if step_ok[a] and not std[a]:
                th = r[2, j]
                pose[a] = (r[0, j] + wb * math.cos(th), r[1, j] + wb * math.sin(th), th,
                           r[3, j], r[4, j])
                x_cl[a] = r[[6, 7, 8, 9, 10, 11], j]
            elif step_ok[a]:
                pose[a, 3:] = 0.0
                x_cl[a, [1, 2, 4, 5]] = 0.0
        marked = collision_step(su, t, pose[:, :2], pose[:, 2], step_ok)
        status = np.where(marked, COLLISION, status)
        traj.append(pose.copy())
        steps.append(status.copy())
    return x_cl, pose, status, np.stack(traj), np.stack(steps)


def simulate(config, request, *, lines, dtype=torch.float64, device="cpu"):
    """The free-running closed loop of one request, in the entry's answer
    form (`entries/device_run.py::Entry.answer`)."""
    su = setup(config, lines[0], request)
    a_n = len(su.pose0)
    x_cl, pose = su.x_cl0.copy(), np.column_stack([su.pose0, np.zeros(a_n)])
    status = np.full(a_n, RUNNING)
    bank, bank_len = su.bank0.copy(), su.bank_len0.copy()
    out = {k: [] for k in ("found", "x_cl", "sel", "cost", "traj", "status_steps")}
    for c in range(su.n_cycles):
        plans, status = _solve(su, c, dict(x_cl=x_cl, pose=pose, status=status),
                                  dict(bank=bank, bank_len=bank_len), dtype=dtype,
                                  device=device)
        running = status == RUNNING
        found = np.array([pl.found for pl in plans])
        std = running & ~found & (pose[:, 3] <= 0.1)
        fb_ok = np.array([pl.fb_ok for pl in plans])
        status = np.where(running & ~found & ~std & ~fb_ok & (c * su.k < su.max_steps),
                          ERROR, status)
        out["found"].append(found)
        out["x_cl"].append(x_cl.copy())
        out["sel"].append(np.stack([pl.sel.double().cpu().numpy() for pl in plans]))
        out["cost"].append(np.array([float(pl.cost[pl.idx]) for pl in plans]))
        bank, bank_len = bank_of(su, plans, pose, std)
        x_cl, pose, status, traj, steps = execute(su, c, plans, x_cl, pose, status, std)
        out["traj"].append(traj)
        out["status_steps"].append(steps)
    res = {k: np.stack(v) for k, v in out.items()}
    res["traj"] = res["traj"].reshape((-1, a_n, 5))[:su.max_steps]
    res["status_steps"] = res["status_steps"].reshape((-1, a_n))[:su.max_steps]
    res["status"] = np.where(status == RUNNING, TIMELIMIT, status)
    return res
