"""Drivable-area corridor: lateral free-space bounds along the reference path.

The port's own copy of `frenetix_tpu/geometry/corridor.py`, NumPy route only
(the JAX package's optional compiled scan is not carried; a parity test holds
this scan against the original's result).

The drivable area is precomputed on the host as a *corridor* in Frenet space:
two tables d_min(s), d_max(s) on the reference path's uniform s-grid (the
lateral extent of the drivable-area union along each normal, scanned outward
from the path).  On the device the road check then rides the same table
interpolation as everything else and costs O(M·N) comparisons.  Limitation:
along a normal the drivable set is approximated by the contiguous free
interval containing the path point; disconnected drivable intervals (e.g.
across a median strip) are truncated, which is conservative.
"""
from __future__ import annotations

import numpy as np

__all__ = ["strip_corridor", "corridor_from_polygons", "corridor_from_lanelets"]


def strip_corridor(ref, half_width: float) -> np.ndarray:
    """Constant ±half_width corridor (synthetic roads / benchmarks). (R, 2)."""
    r = np.asarray(ref.s).shape[0]
    out = np.empty((r, 2), dtype=np.asarray(ref.s).dtype)
    out[:, 0] = -half_width
    out[:, 1] = half_width
    return out


def _points_in_polygons(points: np.ndarray, polygons: list[np.ndarray],
                        chunk: int = 16384) -> np.ndarray:
    """Even-odd point-in-polygon union test (host, NumPy).

    points (P, 2); polygons: list of (V_i, 2) rings.  Returns (P,) bool —
    inside any polygon.  Same crossing arithmetic as the JAX package's dense
    (P, V) version, evaluated only where it can count: points inside the
    ring's bounding box, and of those only the (point, edge) pairs whose edge
    straddles the point's y (few per point on a road polygon).
    """
    inside = np.zeros(len(points), dtype=bool)
    for poly in polygons:
        a = poly
        b = np.roll(poly, -1, axis=0)
        ax, ay, bx, by = a[:, 0], a[:, 1], b[:, 0], b[:, 1]
        in_box = np.nonzero(
            (points[:, 0] >= ax.min()) & (points[:, 0] <= ax.max())
            & (points[:, 1] >= ay.min()) & (points[:, 1] <= ay.max()))[0]
        for lo in range(0, len(in_box), chunk):
            sel = in_box[lo:lo + chunk]
            px, py = points[sel, 0], points[sel, 1]
            straddles = (ay[None, :] > py[:, None]) != (by[None, :] > py[:, None])
            pi, vi = np.nonzero(straddles)
            x_int = ax[vi] + (py[pi] - ay[vi]) * (bx[vi] - ax[vi]) / (by[vi] - ay[vi])
            crossings = np.bincount(pi[px[pi] < x_int], minlength=len(sel))
            inside[sel] |= (crossings % 2) == 1
    return inside


def corridor_from_polygons(
    ref,
    polygons: list[np.ndarray],
    *,
    d_max: float = 8.0,
    d_step: float = 0.25,
) -> np.ndarray:
    """Scan the drivable-area union along each reference-path normal.

    For every table vertex, samples d ∈ [-d_max, d_max] at `d_step` and takes
    the contiguous free interval around d=0 (expanded by d_step/2 so the bound
    sits between the last free and first blocked sample).  Returns (R, 2)
    [d_min, d_max] per vertex; vertices whose path point is itself off the
    drivable area get a degenerate [0, 0] corridor.
    """
    xy = np.asarray(ref.xy, dtype=np.float64)
    theta = np.asarray(ref.theta, dtype=np.float64)

    r = xy.shape[0]
    normals = np.stack([-np.sin(theta), np.cos(theta)], axis=1)  # (R, 2)

    d_samples = np.arange(-d_max, d_max + d_step / 2, d_step)  # (K,)
    k = len(d_samples)
    pts = xy[:, None, :] + d_samples[None, :, None] * normals[:, None, :]
    inside = _points_in_polygons(pts.reshape(-1, 2), polygons).reshape(r, k)

    zero_idx = int(np.argmin(np.abs(d_samples)))
    out = np.zeros((r, 2), dtype=np.asarray(ref.s).dtype)
    for i in range(r):
        row = inside[i]
        if not row[zero_idx]:
            continue  # path point off-road → degenerate corridor
        lo = zero_idx
        while lo > 0 and row[lo - 1]:
            lo -= 1
        hi = zero_idx
        while hi < k - 1 and row[hi + 1]:
            hi += 1
        out[i, 0] = d_samples[lo] - d_step / 2
        out[i, 1] = d_samples[hi] + d_step / 2
    return out


def corridor_from_lanelets(ref, lanelets, **kw) -> np.ndarray:
    """Corridor from lanelet strips: each lanelet polygon is its left-vertex
    chain + reversed right-vertex chain."""
    polys = []
    for ll in lanelets:
        left = np.asarray(ll.left_vertices, dtype=np.float64)
        right = np.asarray(ll.right_vertices, dtype=np.float64)
        polys.append(np.concatenate([left, right[::-1]], axis=0))
    return corridor_from_polygons(ref, polys, **kw)
