"""Batched collision checks: OBB–OBB against predicted obstacles and the
drivable-corridor road-departure check, for all candidates at once.

PyTorch port of `frenetix_tpu/ops/collision.py`: the cycle runs the
prediction check and the corridor departure check; the departure check
against per-segment lanelet quads (`road_boundary_departure`) is the public
alternative to the corridor.  Ego boxes sit at the vehicle center (the
planner's states are at the rear axle, shifted forward by wb_rear_axle).
Rollouts and predictions may carry leading agent axes.
"""
from __future__ import annotations

import torch

__all__ = ["obb_overlap", "ego_centers", "prediction_collisions", "points_in_quads",
           "road_departure_corridor", "road_boundary_departure"]


def obb_overlap(ca, theta_a, ha, cb, theta_b, hb):
    """Separating-axis OBB–OBB overlap test, elementwise and broadcast.

    ca/cb: (..., 2) centers; theta: (...,) headings; ha/hb: (..., 2)
    half-sizes (half_length, half_width).  Returns (...,) bool."""
    dx = cb[..., 0] - ca[..., 0]
    dy = cb[..., 1] - ca[..., 1]
    ac, as_ = torch.cos(theta_a), torch.sin(theta_a)
    bc, bs = torch.cos(theta_b), torch.sin(theta_b)
    al, aw = ha[..., 0], ha[..., 1]
    bl, bw = hb[..., 0], hb[..., 1]
    # |a_i · b_j| entries: cd = |a1·b1| = |a2·b2|, sd = |a1·b2| = |a2·b1|
    cd = torch.abs(ac * bc + as_ * bs)
    sd = torch.abs(as_ * bc - ac * bs)
    separated = (
        (torch.abs(dx * ac + dy * as_) > al + bl * cd + bw * sd)
        | (torch.abs(dy * ac - dx * as_) > aw + bl * sd + bw * cd)
        | (torch.abs(dx * bc + dy * bs) > bl + al * cd + aw * sd)
        | (torch.abs(dy * bc - dx * bs) > bw + al * sd + aw * cd)
    )
    return ~separated


def ego_centers(ro, wb_rear_axle):
    """(M, N+1, 2) vehicle-center positions of all candidates."""
    cx = ro.x + wb_rear_axle * torch.cos(ro.theta_gl)
    cy = ro.y + wb_rear_axle * torch.sin(ro.theta_gl)
    return torch.stack([cx, cy], dim=-1)


def prediction_collisions(ro, preds, veh):
    """(M,) bool — the candidate's box at step i (1 <= i <= t, t = min(N, T))
    overlaps an obstacle box at prediction step i-1."""
    if preds.num_obstacles == 0:
        return torch.zeros(ro.x.shape[:-1], dtype=torch.bool, device=ro.x.device)
    n1 = ro.x.shape[-1]
    t = min(n1 - 1, preds.horizon)

    ego_c = ego_centers(ro, veh.wb_rear_axle)[..., 1 : t + 1, :]  # (M, t, 2)
    ego_th = ro.theta_gl[..., 1 : t + 1]
    # two fills, not a host list: no host→device copy, so the cycle can be
    # captured into a CUDA graph and never waits for the host
    ego_h = torch.full((2,), veh.length / 2.0, dtype=ro.x.dtype, device=ro.x.device)
    ego_h[1:].fill_(veh.width / 2.0)

    obs_c = preds.means[..., :t, :]                                # (O, t, 2)
    obs_th = preds.orientations[..., :t]
    obs_h = torch.stack([preds.lengths / 2.0, preds.widths / 2.0], dim=-1)

    hit = obb_overlap(
        ego_c[..., :, None, :, :],      # (M, 1, t, 2)
        ego_th[..., :, None, :],
        ego_h,
        obs_c[..., None, :, :, :],      # (1, O, t, 2)
        obs_th[..., None, :, :],
        obs_h[..., None, :, None, :],
    )                                   # (M, O, t)
    hit = hit & preds.valid[..., None, :, :t]
    return torch.any(hit.flatten(-2), dim=-1)


def road_departure_corridor(ro, veh):
    """First step at which the ego footprint leaves the drivable corridor
    d_min(s) <= d <= d_max(s), whose bounds the rollout interpolated into
    `ro.extras`.  Returns (first_step (M,) int32, -1 if never; the velocity
    at that step, 0 if never)."""
    n1 = ro.x.shape[-1]
    d_lo = ro.extras[0]
    d_hi = ro.extras[1]
    sin_t = torch.sin(ro.theta_cl)
    cos_t = torch.cos(ro.theta_cl)
    d_center = ro.d + veh.wb_rear_axle * sin_t
    ext = 0.5 * veh.length * torch.abs(sin_t) + 0.5 * veh.width * torch.abs(cos_t)
    off_road = (d_center - ext < d_lo) | (d_center + ext > d_hi)
    step = torch.arange(n1, device=ro.x.device)
    first = torch.amin(torch.where(off_road, step, n1), dim=-1)
    never = first == n1
    first_step = torch.where(never, -1, first).to(torch.int32)
    v_at = torch.gather(ro.v, -1, torch.where(never, 0, first)[..., None])[..., 0]
    return first_step, torch.where(never, torch.zeros_like(v_at), v_at)


def points_in_quads(points, quads):
    """(..., 2) points x (Q, 4, 2) convex quads -> (...,) bool "inside any
    quad" (on an edge counts as inside; either winding)."""
    p = points[..., None, None, :]                     # (..., 1, 1, 2)
    a = quads                                          # (Q, 4, 2)
    edge = torch.roll(quads, -1, dims=-2) - a          # (Q, 4, 2)
    rel = p - a                                        # (..., Q, 4, 2)
    cross = edge[..., 0] * rel[..., 1] - edge[..., 1] * rel[..., 0]  # (..., Q, 4)
    inside_ccw = torch.all(cross >= 0.0, dim=-1)
    inside_cw = torch.all(cross <= 0.0, dim=-1)
    return torch.any(inside_ccw | inside_cw, dim=-1)


def road_boundary_departure(ro, veh, quads):
    """First step at which any corner of the ego box leaves the drivable
    area, the union of the (Q, 4, 2) quads.  Returns (first_step (..., M)
    int32, -1 if never; the velocity at that step, 0 if never); with no
    quads nothing departs."""
    n1 = ro.x.shape[-1]
    if quads.shape[0] == 0:
        return (torch.full(ro.x.shape[:-1], -1, dtype=torch.int32, device=ro.x.device),
                torch.zeros(ro.x.shape[:-1], dtype=ro.x.dtype, device=ro.x.device))
    centers = ego_centers(ro, veh.wb_rear_axle)        # (..., M, N+1, 2)
    hl, hw = veh.length / 2.0, veh.width / 2.0
    signs = torch.tensor([[1, 1], [1, -1], [-1, 1], [-1, -1]], dtype=ro.x.dtype,
                         device=ro.x.device)           # (4, 2)
    # corner (sx, sy): sx·hl·(cos, sin) + sy·hw·(-sin, cos)
    c = torch.cos(ro.theta_gl)[..., None]              # (..., M, N+1, 1)
    s = torch.sin(ro.theta_gl)[..., None]
    sx = signs[:, 0] * hl
    sy = signs[:, 1] * hw
    offsets = torch.stack([sx * c - sy * s, sx * s + sy * c], dim=-1)
    corners = centers[..., None, :] + offsets          # (..., M, N+1, 4, 2)
    inside = points_in_quads(corners, quads)           # (..., M, N+1, 4)
    off_road = torch.any(~inside, dim=-1)              # (..., M, N+1)
    step = torch.arange(n1, device=ro.x.device)
    first = torch.amin(torch.where(off_road, step, n1), dim=-1)
    never = first == n1
    first_step = torch.where(never, -1, first).to(torch.int32)
    v_at = torch.gather(ro.v, -1, torch.where(never, 0, first)[..., None])[..., 0]
    return first_step, torch.where(never, torch.zeros_like(v_at), v_at)
