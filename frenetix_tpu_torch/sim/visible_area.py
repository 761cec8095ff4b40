"""Visible area: polar ray-cast visibility over road walls and obstacles.

The port's copy of `frenetix_tpu/sim/visible_area.py` (host NumPy), with the
two batched functions in torch.

Visibility from a point is a star-shaped region, so it is represented
exactly in polar form: K rays from the ego, each clipped at the first
occluding segment,

    r_vis(φ_k) = min(sensor_radius, min_t over occluder segments).

Occluders are (a) the boundary of the dissolved lanelet union (walls) and
(b) the edges of obstacle boxes.  The whole computation is one vectorized
(K × S) ray-segment intersection; the polygon for a plot is the polar ring.
"""
from __future__ import annotations

import math

import numpy as np
import torch

__all__ = [
    "road_boundary_segments",
    "obstacle_obb_segments",
    "polar_visibility",
    "obb_segments_batch",
    "polar_visibility_batch",
    "VisibleArea",
    "compute_visible_area",
]


def road_boundary_segments(scenario) -> np.ndarray:
    """(S, 2, 2) boundary segments of the dissolved lanelet union.

    Edges shared by two lanelet polygons (adjacent lanes, successor joints)
    are interior to the union and do not block sight; they appear twice in
    the per-lanelet edge lists and are dropped by parity.  Static geometry,
    cached on the scenario.
    """
    cached = getattr(scenario, "_road_segments_cache", None)
    if cached is not None:
        return cached
    counts: dict = {}
    segs: dict = {}
    for ll in scenario.lanelets.values():
        ring = ll.polygon
        for p, q in zip(ring, np.roll(ring, -1, axis=0)):
            if np.allclose(p, q):
                continue
            key = tuple(sorted((
                (round(float(p[0]), 3), round(float(p[1]), 3)),
                (round(float(q[0]), 3), round(float(q[1]), 3)),
            )))
            counts[key] = counts.get(key, 0) + 1
            segs[key] = (p, q)
    out = [segs[k] for k, c in counts.items() if c == 1]
    result = np.asarray(out) if out else np.zeros((0, 2, 2))
    scenario._road_segments_cache = result
    return result


def obstacle_obb_segments(position, orientation, length, width) -> np.ndarray:
    """(4, 2, 2) edge segments of one obstacle's oriented box."""
    c, s = np.cos(orientation), np.sin(orientation)
    rot = np.array([[c, -s], [s, c]])
    half = np.array([
        [length / 2, width / 2], [length / 2, -width / 2],
        [-length / 2, -width / 2], [-length / 2, width / 2],
    ])
    corners = half @ rot.T + np.asarray(position)
    nxt = np.roll(corners, -1, axis=0)
    return np.stack([corners, nxt], axis=1)


def polar_visibility(ego_pos, segments, radius, n_rays: int = 720):
    """Clip K rays at their first occluder: (phi (K,), r_vis (K,)).

    One vectorized (K, S) intersection solve, ego + t·u = a + s·(b−a) with
    t > 0 and s ∈ [0, 1].  A ray parallel to a segment divides by zero and
    is masked."""
    ego = np.asarray(ego_pos, dtype=np.float64)
    phi = np.linspace(-np.pi, np.pi, n_rays, endpoint=False)
    u = np.stack([np.cos(phi), np.sin(phi)], axis=1)          # (K, 2)
    if len(segments) > 0:
        # exact cull: a segment entirely outside the sensor disk can only
        # cut rays beyond the radius clamp: same result, fewer columns
        sa, sb = segments[:, 0], segments[:, 1]
        ab = sb - sa
        length2 = np.maximum((ab * ab).sum(axis=1), 1e-12)
        tt = np.clip(((ego[None] - sa) * ab).sum(axis=1) / length2, 0.0, 1.0)
        near = sa + tt[:, None] * ab
        segments = segments[np.linalg.norm(near - ego[None], axis=1)
                            <= float(radius)]
    if len(segments) == 0:
        return phi, np.full(n_rays, float(radius))
    a = segments[:, 0]                                         # (S, 2)
    d = segments[:, 1] - segments[:, 0]                        # (S, 2)
    ao = a - ego                                               # (S, 2)
    denom = u[:, None, 0] * d[None, :, 1] - u[:, None, 1] * d[None, :, 0]  # (K, S)
    with np.errstate(divide="ignore", invalid="ignore"):
        t = (ao[None, :, 0] * d[None, :, 1] - ao[None, :, 1] * d[None, :, 0]) / denom
        s = (ao[None, :, 0] * u[:, None, 1] - ao[None, :, 1] * u[:, None, 0]) / denom
    hit = (np.abs(denom) > 1e-12) & (s >= 0.0) & (s <= 1.0) & (t > 1e-9)
    t = np.where(hit, t, np.inf)
    r_vis = np.minimum(t.min(axis=1), float(radius))
    return phi, r_vis


def obb_segments_batch(centers, thetas, half_dims):
    """Torch twin of `obstacle_obb_segments` over a batch: centers (..., 2),
    orientations (...), half-dims (..., 2) or (2,) → (..., 4, 2, 2) edge
    segments on the centers' device."""
    dtype, device = centers.dtype, centers.device
    half = torch.as_tensor(half_dims, dtype=dtype, device=device).expand(centers.shape)
    c, s = torch.cos(thetas), torch.sin(thetas)
    # the corner signs (+,+), (+,−), (−,−), (−,+) by fills, not a host list:
    # no host→device copy, so a CUDA graph can capture it
    signs = torch.ones((4, 2), dtype=dtype, device=device)
    signs[1:3, 1] = -1.0
    signs[2:, 0] = -1.0
    local = signs * half[..., None, :]                                  # (..., 4, 2)
    wx = c[..., None] * local[..., 0] - s[..., None] * local[..., 1]
    wy = s[..., None] * local[..., 0] + c[..., None] * local[..., 1]
    corners = centers[..., None, :] + torch.stack([wx, wy], dim=-1)     # (..., 4, 2)
    nxt = torch.roll(corners, -1, dims=-2)
    return torch.stack([corners, nxt], dim=-2)                          # (..., 4, 2, 2)


def polar_visibility_batch(ego, seg_a, seg_b, seg_valid, radius,
                           n_rays: int = 720):
    """Torch twin of `polar_visibility` over a masked segment set: ego
    (..., 2), seg_a / seg_b (..., S, 2), seg_valid (..., S), leading axes
    broadcast → r_vis (..., n_rays).

    The NumPy version's distance cull only removes segments whose
    intersections the radius clamp would cut anyway, so a mask replaces the
    filter; the two agree to the last bits of the libraries' sin and cos."""
    dtype, device = ego.dtype, ego.device
    # the rays of np.linspace(-π, π, K, endpoint=False): −π + k·(2π/K)
    phi = -math.pi + torch.arange(n_rays, dtype=dtype, device=device) * (
        2.0 * math.pi / n_rays)
    ux, uy = torch.cos(phi)[:, None], torch.sin(phi)[:, None]  # (K, 1)
    d = (seg_b - seg_a)[..., None, :, :]                        # (..., 1, S, 2)
    ao = (seg_a - ego[..., None, :])[..., None, :, :]           # (..., 1, S, 2)
    denom = ux * d[..., 1] - uy * d[..., 0]                     # (..., K, S)
    crossing = torch.abs(denom) > 1e-12
    safe = torch.where(crossing, denom, torch.ones_like(denom))
    t = (ao[..., 0] * d[..., 1] - ao[..., 1] * d[..., 0]) / safe
    s = (ao[..., 0] * uy - ao[..., 1] * ux) / safe
    hit = crossing & (s >= 0.0) & (s <= 1.0) & (t > 1e-9) & seg_valid[..., None, :]
    t = torch.where(hit, t, torch.full_like(t, torch.inf))
    if t.shape[-1] == 0:
        return torch.full(t.shape[:-1], float(radius), dtype=dtype, device=device)
    return torch.clamp(torch.amin(t, dim=-1), max=float(radius))


class VisibleArea:
    """Polar visible-area map with point and obstacle queries and a polygon
    for plots."""

    def __init__(self, ego_pos, phi, r_vis):
        self.ego = np.asarray(ego_pos, dtype=np.float64)
        self.phi = phi
        self.r_vis = r_vis

    def r_at(self, angles) -> np.ndarray:
        """Visible range at arbitrary angles (nearest-ray lookup)."""
        k = len(self.phi)
        idx = np.round((np.asarray(angles) + np.pi) / (2 * np.pi) * k).astype(int) % k
        return self.r_vis[idx]

    def points_visible(self, points, tol: float = 0.3) -> np.ndarray:
        """(P,) bool: within the clipped range of their ray (`tol` covers
        points ON an occluder edge, e.g. an obstacle's own silhouette)."""
        d = np.atleast_2d(points) - self.ego[None]
        r = np.linalg.norm(d, axis=1)
        ang = np.arctan2(d[:, 1], d[:, 0])
        return r <= self.r_at(ang) + tol

    def obstacle_visible(self, position, orientation, length, width,
                         tol: float = 0.3) -> bool:
        """Any silhouette corner (or the center) visible."""
        segs = obstacle_obb_segments(position, orientation, length, width)
        probes = np.concatenate([segs[:, 0], np.atleast_2d(position)])
        return bool(self.points_visible(probes, tol=tol).any())

    def polygon(self) -> np.ndarray:
        """(K, 2) ring of the visible area."""
        return self.ego[None] + self.r_vis[:, None] * np.stack(
            [np.cos(self.phi), np.sin(self.phi)], axis=1
        )


def compute_visible_area(
    scenario,
    ego_id,
    ego_position,
    time_step: int,
    sensor_radius: float = 50.0,
    *,
    n_rays: int = 720,
    road_segments: np.ndarray = None,
    include_obstacles: bool = True,
    agent_ids=(),
    extra_occluders=(),
) -> VisibleArea:
    """The full visible-area model: road walls + obstacle shadows.

    `road_segments` can be computed once per scenario
    (`road_boundary_segments`): it is static geometry.

    `extra_occluders`: iterable of (position, orientation, length, width) for
    occluders that are not scenario obstacles: in multi-agent runs the other
    agents' live poses (their scenario trajectories are stale once they are
    agents, yet their vehicles still block sight).
    """
    if road_segments is None:
        road_segments = road_boundary_segments(scenario)
    segs = [road_segments.reshape(-1, 2, 2)]
    if include_obstacles:
        excluded = set(agent_ids) | {ego_id}
        for ob in scenario.obstacles.values():
            if ob.obstacle_id in excluded:
                continue
            st = ob.state_at_time(time_step)
            if st is None:
                continue
            # extent margin: a body reaching into range occludes even when
            # its center is just outside
            if np.linalg.norm(np.asarray(st.position) - np.asarray(ego_position)) \
                    > sensor_radius + max(ob.length, ob.width):
                continue
            segs.append(obstacle_obb_segments(
                st.position, st.orientation, ob.length, ob.width
            ))
    for pos, orient, length, width in extra_occluders:
        if np.linalg.norm(np.asarray(pos) - np.asarray(ego_position)) \
                > sensor_radius + max(length, width):
            continue
        segs.append(obstacle_obb_segments(pos, orient, length, width))
    all_segs = np.concatenate(segs, axis=0)
    phi, r_vis = polar_visibility(ego_position, all_segs, sensor_radius, n_rays)
    return VisibleArea(ego_position, phi, r_vis)
