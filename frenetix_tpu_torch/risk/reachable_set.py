"""Reachable sets for the responsibility cost.

PyTorch port of `frenetix_tpu/risk/reachable_set.py`.  Per obstacle and
future time t an over-approximating occupancy: the SPOT hexagon (Koschi &
Althoff) in the obstacle's heading frame, intersected with the lanelets the
obstacle can follow (laterally adjacent lanes plus successors to a depth).
If the ego's planned position at t lies outside every step of an obstacle's
reach set, that obstacle cannot cause the conflict and its risk is
subtracted from the responsibility cost.

Each obstacle's reach set is rasterized once per cycle into a small
occupancy grid (O, T, G, G): on the host in NumPy (`build_reach_set_grids`,
which uploads the finished grid as one tensor) or on the device in torch
(`build_reach_set_grids_device`, for poses that live there).  The
per-candidate test on the device is one gather over (M × O × N) points, with
leading agent axes (`points_in_reach_grids`, `responsibility_reach_grid`).
The sector-annulus model (`reach_set_params`, `point_in_reach_set`,
`responsibility_reach_set`) serves scenarios without lanelet context.

The host lanelet test uses the port's bounding-box crossing scan
(`geometry.corridor._points_in_polygons`); the device rasterizer evaluates the
same crossing formula, so both give equal grids at equal dtype.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from frenetix_tpu_torch.geometry.corridor import _points_in_polygons
from frenetix_tpu_torch.risk.costs import sum_obstacles

__all__ = [
    "reach_set_params",
    "point_in_reach_set",
    "responsibility_reach_set",
    "spot_hexagon_params",
    "hexagon_contains",
    "reachable_lanelet_ids",
    "point_in_lanelet_reach_set",
    "ReachSetGrid",
    "reach_grid_from_numpy",
    "build_reach_set_grids",
    "points_in_reach_grids",
    "responsibility_reach_grid",
    "LaneletTensors",
    "lanelet_tensors",
    "lanelet_tensors_from_numpy",
    "build_reach_set_grids_device",
]

# elements of the (obstacles, cells, lanelets, vertices) crossing tensor per
# chunk of the device rasterizer
_MAX_CROSSING_ELEMENTS = 1 << 24


# ---------------------------------------------------------------------------
# SPOT hexagon
# ---------------------------------------------------------------------------


def spot_hexagon_params(v0: float, dt_rs: float, t_max: float, a_max: float):
    """Per-step hexagon parameters: (c, bx, r, rear), each (T+1,).

    c    = v·t                      (constant-velocity centre)
    bx   = v·t − a²t³/(2v), capped  (Althoff Eq. 4)
    r    = a·t²/2                   (acceleration radius)
    rear = running max of c_t − r_t (no driving backwards)
    """
    v = max(float(v0), 0.01)
    t = np.arange(0.0, t_max + dt_rs / 2, dt_rs)
    c = v * t
    t_bmax = np.sqrt(2.0 / 3.0) * v / a_max
    bx_max = v * t_bmax - a_max**2 * t_bmax**3 / (2 * v)
    bx = v * t - a_max**2 * np.power(t, 3) / (2 * v)
    bx[t > t_bmax] = bx_max
    r = 0.5 * a_max * t**2
    rear = np.maximum.accumulate(c - r)
    return c, bx, r, rear


def hexagon_contains(points_local: np.ndarray, j: int, params, length: float,
                     width: float) -> np.ndarray:
    """(P,) bool: membership in the step-j hexagon (+ vehicle half-dims).

    Between the rear (c_t − r_t, clamped) and b_t the half-width ramps from
    r_t to r_t1; between b_t and the front (c_t1 + r_t1) it is r_t1.
    """
    c, bx, r, rear_run = params
    if j > 0:
        r_t, c_t, b_t = r[j - 1], c[j - 1], bx[j - 1]
    else:
        r_t = c_t = b_t = 0.0
    r_t1, c_t1 = r[j], c[j]
    rear = rear_run[j - 1] if j > 0 else c_t - r_t

    half_l, half_w_veh = length / 2.0, width / 2.0
    x = points_local[:, 0]
    y = np.abs(points_local[:, 1])

    x_lo = rear - half_l
    x_hi = c_t1 + r_t1 + half_l
    # lateral half-width profile: ramp (rear → b_t), then flat r_t1
    denom = max(b_t - rear, 1e-9)
    ramp = r_t + (r_t1 - r_t) * np.clip((x - rear) / denom, 0.0, 1.0)
    half_w = np.where(x >= b_t, r_t1, ramp) + half_w_veh
    return (x >= x_lo) & (x <= x_hi) & (y <= half_w)


# ---------------------------------------------------------------------------
# lanelet closure
# ---------------------------------------------------------------------------


def _parallel_lanelets(scenario, lanelet_id: int) -> list[int]:
    """Laterally adjacent same-direction lanelets."""
    out = [lanelet_id]
    cur = scenario.lanelets.get(lanelet_id)
    while cur is not None and cur.adj_left is not None and cur.adj_left_same_direction:
        out.append(cur.adj_left)
        cur = scenario.lanelets.get(cur.adj_left)
    cur = scenario.lanelets.get(lanelet_id)
    while cur is not None and cur.adj_right is not None and cur.adj_right_same_direction:
        out.append(cur.adj_right)
        cur = scenario.lanelets.get(cur.adj_right)
    return [lid for lid in out if lid in scenario.lanelets]


def reachable_lanelet_ids(scenario, start_ids, depth: int = 3) -> set:
    """Closure of parallels + successors up to `depth` levels."""
    frontier = set()
    for lid in start_ids:
        frontier.update(_parallel_lanelets(scenario, lid))
    seen = set(frontier)
    for _ in range(depth):
        nxt = set()
        for lid in frontier:
            ll = scenario.lanelets.get(lid)
            if ll is None:
                continue
            for suc in ll.successors:
                for p in _parallel_lanelets(scenario, suc):
                    if p not in seen:
                        nxt.add(p)
        seen |= nxt
        frontier = nxt
        if not frontier:
            break
    return seen


def _points_in_rings(points: np.ndarray, rings: list[np.ndarray]) -> np.ndarray:
    """(P,) bool: even-odd membership in ANY of the polygon rings."""
    return _points_in_polygons(np.asarray(points, dtype=np.float64), rings)


def point_in_lanelet_reach_set(points: np.ndarray, j: int, *, position,
                               orientation, velocity, length, width,
                               lanelet_rings, dt_rs=0.2, t_max=2.0, a_max=8.0,
                               params=None) -> np.ndarray:
    """Host reference: exact hexagon ∩ lanelet-union membership of arbitrary
    points at step j (what the grids rasterize)."""
    if params is None:
        params = spot_hexagon_params(velocity, dt_rs, t_max, a_max)
    d = np.atleast_2d(points) - np.asarray(position)[None]
    c, s = np.cos(-orientation), np.sin(-orientation)
    local = np.stack([c * d[:, 0] - s * d[:, 1], s * d[:, 0] + c * d[:, 1]], axis=1)
    in_hex = hexagon_contains(local, j, params, length, width)
    if lanelet_rings:
        in_lane = _points_in_rings(np.atleast_2d(points), lanelet_rings)
    else:
        in_lane = np.ones(len(local), bool)
    return in_hex & in_lane


# ---------------------------------------------------------------------------
# rasterized grids + device gather
# ---------------------------------------------------------------------------


class ReachSetGrid(NamedTuple):
    """Per-obstacle occupancy grids on one device, optionally with leading
    agent axes.

    occupancy[o, t, i, j]: cell (i, j) of obstacle o's grid is reachable at
    reach-set step t.  Cell (i, j) covers the world position
    origin[o] + (i − G/2 + 0.5, j − G/2 + 0.5) · cell[o].  The cell size is
    per obstacle: it grows with the obstacle's speed so that the grid always
    covers the full t_max reach (a fixed extent would cut fast obstacles'
    reach sets and wrongly subtract their risk).
    """

    origin: torch.Tensor      # (..., O, 2) grid centres (obstacle positions)
    occupancy: torch.Tensor   # (..., O, T_rs, G, G) bool
    valid: torch.Tensor       # (..., O) bool
    cell: torch.Tensor        # (..., O) metres per cell
    dt_rs: float


def reach_grid_from_numpy(origin, occupancy, valid, cell, dt_rs, *,
                          device: torch.device, dtype=torch.float64) -> ReachSetGrid:
    """A ReachSetGrid from host arrays (or anything `np.asarray` takes, such
    as the leaves of the JAX package's grid): one upload per leaf."""
    return ReachSetGrid(
        origin=torch.as_tensor(np.array(origin), dtype=dtype, device=device),
        occupancy=torch.as_tensor(np.array(occupancy, dtype=bool), device=device),
        valid=torch.as_tensor(np.array(valid, dtype=bool), device=device),
        cell=torch.as_tensor(np.array(cell), dtype=dtype, device=device),
        dt_rs=float(dt_rs),
    )


def _reach_steps(dt_rs: float, t_max: float) -> int:
    return len(np.arange(0.0, t_max + dt_rs / 2, dt_rs))


def build_reach_set_grids(
    scenario,
    positions,
    orientations,
    velocities,
    lengths,
    widths,
    valid,
    *,
    device: torch.device,
    dtype=torch.float64,
    dt_rs: float = 0.2,
    t_max: float = 2.0,
    a_max: float = 8.0,
    depth: int = 3,
    grid_n: int = 64,
    cell: float = 1.5,
) -> ReachSetGrid:
    """Rasterize every obstacle's lanelet-following reach set on the host
    (NumPy, float64) and upload the grids to `device`, the occupancy of all
    obstacles as one tensor.  Inputs are host arrays of length O."""
    o = len(positions)
    t_steps = _reach_steps(dt_rs, t_max)
    occ = np.zeros((o, t_steps, grid_n, grid_n), bool)
    cells = np.full(o, float(cell))

    # unit cell centres in grid-local coordinates, (G*G, 2)
    axis = np.arange(grid_n) - grid_n / 2 + 0.5
    gx, gy = np.meshgrid(axis, axis, indexing="ij")
    unit_cells = np.stack([gx.ravel(), gy.ravel()], axis=1)

    for k in range(o):
        if not valid[k]:
            continue
        pos = np.asarray(positions[k], dtype=np.float64)
        # the grid's half-extent must cover the full t_max reach
        # (v·t + a·t²/2 + vehicle length + margin)
        reach = (max(float(velocities[k]), 0.0) * t_max
                 + 0.5 * a_max * t_max**2 + float(lengths[k]) + 2.0)
        cells[k] = max(float(cell), 2.0 * reach / grid_n)
        cells_world = unit_cells * cells[k] + pos[None]

        # lanelet closure of the obstacle's current lanelet(s)
        start_ids = scenario.find_lanelets_by_position(pos) if scenario else []
        if start_ids:
            ids = reachable_lanelet_ids(scenario, start_ids, depth)
            rings = [scenario.lanelets[lid].polygon for lid in ids]
            in_lane = _points_in_rings(cells_world, rings)
        else:
            in_lane = np.ones(len(cells_world), bool)  # off the network: hexagon only

        params = spot_hexagon_params(velocities[k], dt_rs, t_max, a_max)
        th = float(orientations[k])
        c, s = np.cos(-th), np.sin(-th)
        d = cells_world - pos[None]
        local = np.stack([c * d[:, 0] - s * d[:, 1], s * d[:, 0] + c * d[:, 1]], axis=1)
        # hexagon test only on the in-lane cells (a small part of the grid)
        idx = np.where(in_lane)[0]
        loc = local[idx]
        for j in range(t_steps):
            plane = occ[k, j].reshape(-1)
            plane[idx] = hexagon_contains(loc, j, params, float(lengths[k]),
                                          float(widths[k]))

    return reach_grid_from_numpy(
        np.asarray(positions, dtype=np.float64).reshape(o, 2), occ,
        np.asarray(valid, bool), cells, dt_rs, device=device, dtype=dtype)


def points_in_reach_grids(points, step_idx, grid: ReachSetGrid):
    """Device gather: is a point inside an obstacle's reach set at its step?

    `grid` leaves start with the agent axes `*A` (none for one agent);
    points (*A, *C, N, 2) with any candidate axes `*C`, step_idx (N,) integer
    → (*A, *C, O, N) bool.  Points off the grid are unreachable.  One
    `torch.gather` on the occupancy flattened to (*A, O, T·G·G)."""
    g = grid.occupancy.shape[-1]
    t_rs = grid.occupancy.shape[-3]
    o = grid.origin.shape[-2]
    agent = tuple(grid.origin.shape[:-2])
    n_cand = points.dim() - 2 - len(agent)
    cand = tuple(points.shape[len(agent):len(agent) + n_cand])
    n = points.shape[-2]
    ones = (1,) * n_cand

    step_idx = torch.clamp(step_idx.long(), 0, t_rs - 1)
    origin = grid.origin.reshape(agent + ones + (o, 1, 2))
    cell = grid.cell.reshape(agent + ones + (o, 1, 1))
    rel = points[..., None, :, :] - origin                      # (*A, *C, O, N, 2)
    ij = torch.floor(rel / cell + g / 2.0).long()
    inb = torch.all((ij >= 0) & (ij < g), dim=-1)               # before the clip
    i = torch.clamp(ij[..., 0], 0, g - 1)
    j = torch.clamp(ij[..., 1], 0, g - 1)
    flat_idx = step_idx * (g * g) + i * g + j                   # (*A, *C, O, N)

    # gather along the last axis of (*A, O, T·G·G): the obstacle axis of the
    # index goes in front of the candidate axes
    a_n = len(agent)
    idx = flat_idx.movedim(a_n + n_cand, a_n).reshape(agent + (o, -1))
    flat = grid.occupancy.reshape(agent + (o, t_rs * g * g))
    vals = torch.gather(flat, -1, idx).reshape(agent + (o,) + cand + (n,))
    vals = vals.movedim(a_n, a_n + n_cand)                      # (*A, *C, O, N)
    return vals & inb & grid.valid.reshape(agent + ones + (o, 1))


def _responsibility_from_inside(inside, risks):
    """−Σ_o resp_o · obst_risk_o with resp_o = 1 where the ego is never inside
    obstacle o's reach set; `inside` (..., M, O, N)."""
    dtype = risks.obst_risk_per_obst.dtype
    ever_inside = torch.any(inside, dim=-1)                     # (..., M, O)
    # 0/1 in the cost's dtype (a where() of two Python numbers is float32)
    resp = (~ever_inside).to(dtype) * risks.obst_present[..., None, :].to(dtype)
    return -sum_obstacles(resp * risks.obst_risk_per_obst)


def responsibility_reach_grid(ro, grid: ReachSetGrid, risks, dt: float):
    """(..., M) responsibility cost via lanelet reach sets: obstacles whose
    reach set never contains the ego trajectory carry their own risk.
    Rollout (..., M, N+1) and grid / risks with the same leading agent axes."""
    n1 = ro.x.shape[-1]
    if grid.origin.shape[-2] == 0:
        return torch.zeros(ro.x.shape[:-1], dtype=ro.x.dtype, device=ro.x.device)
    n = n1 - 1
    ego = torch.stack([ro.x[..., 1:], ro.y[..., 1:]], dim=-1)   # (..., M, N, 2)
    # reach-set step of planner step k: round(k·dt/dt_rs), ties to even
    k = torch.arange(1, n + 1, dtype=torch.float64, device=ro.x.device)
    step_idx = torch.round(k * dt / grid.dt_rs).long()
    inside = points_in_reach_grids(ego, step_idx, grid)          # (..., M, O, N)
    return _responsibility_from_inside(inside, risks)


# ---------------------------------------------------------------------------
# device-side grid rasterizer (reach sets of poses that live on the device)
# ---------------------------------------------------------------------------


class LaneletTensors(NamedTuple):
    """Static per-scenario lanelet geometry on a device: what the reach-grid
    rasterizer needs to run there.

    Rings are padded to a common vertex count by repeating the last vertex
    (degenerate edges add no crossing; the closing edge stays last → first).
    `closure[l]` is the boolean row of lanelets reachable from start lanelet
    l (`reachable_lanelet_ids` with a single start); the closure of a
    position on several lanelets is the OR of its start rows."""

    rings: torch.Tensor       # (L, E, 2)
    ring_valid: torch.Tensor  # (L,)
    closure: torch.Tensor     # (L, L) bool, closure[start, member]


def lanelet_tensors_from_numpy(rings, ring_valid, closure, *,
                               device: torch.device,
                               dtype=torch.float64) -> LaneletTensors:
    """LaneletTensors from host arrays (or the leaves of the JAX package's)."""
    return LaneletTensors(
        rings=torch.as_tensor(np.array(rings), dtype=dtype, device=device),
        ring_valid=torch.as_tensor(np.array(ring_valid, dtype=bool), device=device),
        closure=torch.as_tensor(np.array(closure, dtype=bool), device=device),
    )


def lanelet_tensors(scenario, depth: int = 3, *, device: torch.device,
                    dtype=torch.float64) -> LaneletTensors:
    """Host precompute of `LaneletTensors`, cached on the scenario per
    (depth, device, dtype)."""
    key = (depth, str(torch.device(device)), str(dtype))
    cache = getattr(scenario, "_lanelet_tensors_cache", None)
    if cache is not None and cache[0] == key:
        return cache[1]
    ids = list(scenario.lanelets) if scenario is not None else []
    l_n = len(ids) or 1
    e_max = max((len(scenario.lanelets[i].polygon) for i in ids), default=3) or 3
    rings = np.zeros((l_n, e_max, 2), np.float64)
    ring_valid = np.zeros(l_n, bool)
    closure = np.zeros((l_n, l_n), bool)
    index = {lid: k for k, lid in enumerate(ids)}
    for k, lid in enumerate(ids):
        ring = np.asarray(scenario.lanelets[lid].polygon, np.float64)
        rings[k, : len(ring)] = ring
        rings[k, len(ring):] = ring[-1]
        ring_valid[k] = True
        for member in reachable_lanelet_ids(scenario, [lid], depth):
            closure[k, index[member]] = True
    out = lanelet_tensors_from_numpy(rings, ring_valid, closure, device=device,
                                     dtype=dtype)
    if scenario is not None:
        scenario._lanelet_tensors_cache = (key, out)
    return out


def _crossings_odd(px, py, ax, ay, bx, by):
    """Even-odd crossing parity of points against ring edges a → b, summed
    over the trailing vertex axis.  The crossing abscissa is
    a_x + (p_y − a_y)·(b_x − a_x)/(b_y − a_y), as in the host scan; a
    horizontal edge divides by zero and is masked by the straddle test."""
    cond = (ay > py) != (by > py)
    x_int = ax + (py - ay) * (bx - ax) / (by - ay)
    return (torch.sum(cond & (px < x_int), dim=-1) % 2).bool()


def _reach_grids_device(pos, th, v, length, width, valid, lane: LaneletTensors,
                        *, dt_rs, t_max, a_max, grid_n, cell, t_steps):
    """Rasterized reach grids of B obstacles at once, in torch: the device
    twin of the host loop body of `build_reach_set_grids` (same formulas in
    the same order, so the grids are equal at equal dtype).  pos (B, 2), the
    other inputs (B,).  Returns (occupancy (B, T, G, G), cell (B,))."""
    dtype, device = pos.dtype, pos.device
    reach = (torch.clamp(v, min=0.0) * t_max + 0.5 * a_max * t_max ** 2
             + length + 2.0)
    cell_o = torch.clamp(2.0 * reach / grid_n, min=float(cell))
    # invalid rows keep the default cell size (the host loop skips them)
    cell_o = torch.where(valid, cell_o, torch.full_like(cell_o, float(cell)))

    axis = torch.arange(grid_n, dtype=dtype, device=device) - grid_n / 2 + 0.5
    gx, gy = torch.meshgrid(axis, axis, indexing="ij")
    unit = torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=1)     # (P, 2)
    cells_world = unit[None] * cell_o[:, None, None] + pos[:, None]  # (B, P, 2)

    # ---- start lanelets of each obstacle, (B, L) ---------------------------
    # one lanelet set for all rows, (L, E, 2), or one per row, (B, L, E, 2)
    per_row = lane.rings.dim() == 4
    a = lane.rings
    b = torch.roll(lane.rings, -1, dims=-2)
    ax, ay, bx, by = (x if per_row else x[None]
                      for x in (a[..., 0], a[..., 1], b[..., 0], b[..., 1]))
    start = _crossings_odd(pos[:, 0, None, None], pos[:, 1, None, None],
                           ax, ay, bx, by) & lane.ring_valid
    any_start = torch.any(start, dim=1)                              # (B,)
    closure = lane.closure if per_row else lane.closure[None]
    closure_lanes = torch.any(closure & start[:, :, None], dim=1)    # (B, L)

    # ---- cell membership in the closure union, (B, P) ----------------------
    in_ring = _crossings_odd(
        cells_world[:, :, 0, None, None], cells_world[:, :, 1, None, None],
        ax[:, None], ay[:, None], bx[:, None], by[:, None])           # (B, P, L)
    in_lane = torch.any(in_ring & closure_lanes[:, None, :], dim=2)
    in_lane = torch.where(any_start[:, None], in_lane, torch.ones_like(in_lane))

    # ---- SPOT hexagon, all steps at once -----------------------------------
    vv = torch.clamp(v, min=0.01)[:, None]                           # (B, 1)
    t = (torch.arange(t_steps, dtype=dtype, device=device) * dt_rs)[None]  # (1, T)
    c_arr = vv * t
    t_bmax = math.sqrt(2.0 / 3.0) * vv / a_max
    bx_max = vv * t_bmax - a_max ** 2 * t_bmax ** 3 / (2 * vv)
    bx_t = vv * t - a_max ** 2 * t ** 3 / (2 * vv)
    bx_t = torch.where(t > t_bmax, bx_max, bx_t)
    r = (0.5 * a_max * t ** 2).expand_as(c_arr)
    rear_run = torch.cummax(c_arr - r, dim=1).values

    def prev(arr):      # the value of the step before; zeros at step 0
        return torch.cat([torch.zeros_like(arr[:, :1]), arr[:, :-1]], dim=1)

    r_prev, b_prev, rear_prev = prev(r), prev(bx_t), prev(rear_run)

    cth, sth = torch.cos(-th)[:, None], torch.sin(-th)[:, None]
    d = cells_world - pos[:, None]
    x = (cth * d[..., 0] - sth * d[..., 1])[:, None, :]              # (B, 1, P)
    y = torch.abs(sth * d[..., 0] + cth * d[..., 1])[:, None, :]

    l2, w2 = (length / 2.0)[:, None, None], (width / 2.0)[:, None, None]
    x_lo = rear_prev[:, :, None] - l2                                # (B, T, 1)
    x_hi = (c_arr + r)[:, :, None] + l2
    denom = torch.clamp(b_prev - rear_prev, min=1e-9)[:, :, None]
    ramp = r_prev[:, :, None] + (r - r_prev)[:, :, None] * torch.clamp(
        (x - rear_prev[:, :, None]) / denom, 0.0, 1.0)
    half_w = torch.where(x >= b_prev[:, :, None], r[:, :, None].expand_as(ramp),
                         ramp) + w2
    in_hex = (x >= x_lo) & (x <= x_hi) & (y <= half_w)               # (B, T, P)

    occ = in_hex & in_lane[:, None, :] & valid[:, None, None]
    return occ.reshape(-1, t_steps, grid_n, grid_n), cell_o


def build_reach_set_grids_device(
    positions, orientations, velocities, lengths, widths, valid,
    lane: LaneletTensors,
    *,
    dt_rs: float = 0.2,
    t_max: float = 2.0,
    a_max: float = 8.0,
    grid_n: int = 64,
    cell: float = 1.5,
) -> ReachSetGrid:
    """`build_reach_set_grids` on the device, in torch: for obstacle poses
    that live there (peer agents of a device-resident simulation).  Inputs
    are (O, ...) tensors on the device of `lane`
    (`lanelet_tensors(scenario, device=...)`), or one lanelet set per row:
    LaneletTensors leaves with a leading (O,) axis (the rows of a fleet's
    members, each on its own map).  The obstacles are walked in chunks so
    that the (chunk, cells, lanelets, vertices) crossing tensor stays
    bounded; the chunking changes no value."""
    t_steps = _reach_steps(dt_rs, t_max)
    o = positions.shape[0]
    per_row = lane.rings.dim() == 4
    l_n, e_n = lane.rings.shape[-3], lane.rings.shape[-2]
    chunk = max(1, _MAX_CROSSING_ELEMENTS // (grid_n * grid_n * l_n * e_n))
    occs, cells = [], []
    for lo in range(0, o, chunk):
        sl = slice(lo, lo + chunk)
        occ, cell_o = _reach_grids_device(
            positions[sl], orientations[sl], velocities[sl], lengths[sl],
            widths[sl], valid[sl],
            LaneletTensors(*(x[sl] for x in lane)) if per_row else lane,
            dt_rs=dt_rs, t_max=t_max, a_max=a_max,
            grid_n=grid_n, cell=cell, t_steps=t_steps)
        occs.append(occ)
        cells.append(cell_o)
    if occs:
        occupancy, cell_all = torch.cat(occs), torch.cat(cells)
    else:
        occupancy = torch.zeros((0, t_steps, grid_n, grid_n), dtype=torch.bool,
                                device=positions.device)
        cell_all = torch.zeros((0,), dtype=positions.dtype, device=positions.device)
    return ReachSetGrid(origin=positions, occupancy=occupancy, valid=valid,
                        cell=cell_all, dt_rs=float(dt_rs))


# ---------------------------------------------------------------------------
# sector-annulus model (for scenarios without lanelet context)
# ---------------------------------------------------------------------------


def reach_set_params(preds, *, a_max=7.0, yaw_spread_rate=0.35, dt=0.1):
    """Per (obstacle, step) reach-set parameters from the obstacles' current
    states: radius interval [r_min, r_max] and heading spread at each future
    step.  Only the step-0 pose and velocity of `preds` are used (a reach set
    bounds what the obstacle could do, not the prediction); `dt` is the
    prediction step length."""
    t_pred = preds.orientations.shape[-1]
    dt_steps = torch.arange(1, t_pred + 1, dtype=preds.means.dtype,
                            device=preds.means.device)
    v0 = preds.velocities[..., 0][..., None]        # (..., O, 1)
    tt = dt_steps * dt                              # (T,) horizon seconds
    r_max = v0 * tt + 0.5 * a_max * tt**2
    r_min = torch.clamp(v0 * tt - 0.5 * a_max * tt**2, min=0.0)
    spread = torch.clamp(yaw_spread_rate * tt, max=math.pi / 2)[None, :]
    return dict(
        origin=preds.means[..., 0, :],              # (..., O, 2)
        heading=preds.orientations[..., 0],         # (..., O)
        r_min=r_min, r_max=r_max,                   # (..., O, T)
        spread=spread,                              # (1, T), the same for all
    )


def point_in_reach_set(points, rs):
    """points (..., M, T, 2) → (..., M, O, T) bool: inside the sector annulus
    of `rs` (leaves (..., O, ...))."""
    d = points[..., None, :, :] - rs["origin"][..., None, :, None, :]
    dist = torch.sqrt(torch.sum(d * d, dim=-1))
    ang = torch.atan2(d[..., 1], d[..., 0])
    dang = torch.abs(torch.remainder(
        ang - rs["heading"][..., None, :, None] + math.pi, 2 * math.pi) - math.pi)
    inside = (
        (dist >= rs["r_min"][..., None, :, :] - 1e-6)
        & (dist <= rs["r_max"][..., None, :, :] + 1e-6)
        & (dang <= rs["spread"][..., None, :, :])
    )
    # an obstacle can stand still: near its origin is always reachable
    return inside | (dist <= 2.0)


def responsibility_reach_set(ro, preds, risks, dt=0.1):
    """(..., M) responsibility cost via sector-annulus reach sets."""
    if preds.num_obstacles == 0:
        return torch.zeros(ro.x.shape[:-1], dtype=ro.x.dtype, device=ro.x.device)
    t = min(ro.x.shape[-1] - 1, preds.horizon)
    rs = reach_set_params(preds, dt=dt)
    rs = {k: (v[..., :t] if k in ("r_min", "r_max", "spread") else v)
          for k, v in rs.items()}
    ego = torch.stack([ro.x[..., 1 : t + 1], ro.y[..., 1 : t + 1]], dim=-1)
    inside = point_in_reach_set(ego, rs) & preds.valid[..., None, :, :t]
    return _responsibility_from_inside(inside, risks)
