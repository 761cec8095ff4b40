"""Reference-path preprocessing: polyline → Frenet tables (host NumPy).

The port's own copy of `frenetix_tpu/geometry/refpath.py` (same functions,
same arithmetic; a parity test holds the two against each other):
  - pathlength / curvature / orientation tables
  - spline smoothing
  - linear extension at both ends
  - uniform resampling in arclength

The tables are built once per reference path on the host in float64 and
copied to the planner's device as tensors; per-candidate conversions are
gathers plus linear interpolation (see `frenetix_tpu_torch.geometry.frenet`).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

__all__ = [
    "RefPathTable",
    "polyline_pathlength",
    "polyline_orientation",
    "polyline_curvature",
    "resample_polyline",
    "extend_polyline",
    "smooth_polyline",
    "prepare_reference_path",
]


class RefPathTable(NamedTuple):
    """Reference-path tables (all shape (R,) / (R, 2)); `theta` is unwrapped
    (np.unwrap).

    Invariant: vertices are spaced *exactly uniformly* in arclength (spacing
    `ds = s[1]-s[0]`, s[0] = 0), so segment lookup is pure arithmetic —
    `idx = floor(s/ds)` — instead of a binary search.
    `prepare_reference_path` establishes the invariant by resampling every
    table onto a uniform s-grid.
    """

    xy: np.ndarray      # (R, 2) vertices
    s: np.ndarray       # (R,)  pathlength at each vertex ("ref_pos"), uniform
    theta: np.ndarray   # (R,)  unwrapped orientation      ("ref_theta")
    kappa: np.ndarray   # (R,)  curvature                  ("ref_curv")
    kappa_d: np.ndarray  # (R,) dκ/ds                      ("ref_curv_d")
    kappa_dd: np.ndarray  # (R,) d²κ/ds²                   ("ref_curv_dd")

    @property
    def length(self) -> float:
        return float(self.s[-1])


def polyline_pathlength(xy: np.ndarray) -> np.ndarray:
    """Cumulative arclength along the polyline; s[0] = 0."""
    seg = np.linalg.norm(np.diff(xy, axis=0), axis=1)
    return np.concatenate([[0.0], np.cumsum(seg)])


def polyline_orientation(xy: np.ndarray) -> np.ndarray:
    """Per-vertex tangent orientation (forward differences, last repeated)."""
    d = np.diff(xy, axis=0)
    theta = np.arctan2(d[:, 1], d[:, 0])
    return np.concatenate([theta, theta[-1:]])


def polyline_curvature(xy: np.ndarray) -> np.ndarray:
    """Signed curvature κ = (x'y'' - y'x'') / (x'^2 + y'^2)^{3/2} via np.gradient."""
    x_d = np.gradient(xy[:, 0])
    x_dd = np.gradient(x_d)
    y_d = np.gradient(xy[:, 1])
    y_dd = np.gradient(y_d)
    denom = (x_d * x_d + y_d * y_d) ** 1.5
    denom = np.where(denom < 1e-12, 1e-12, denom)
    return (x_d * y_dd - y_d * x_dd) / denom


def resample_polyline(xy: np.ndarray, step: float) -> np.ndarray:
    """Resample the polyline to (approximately) uniform vertex spacing `step`."""
    s = polyline_pathlength(xy)
    total = s[-1]
    if total <= step:
        return xy.copy()
    n = int(np.floor(total / step)) + 1
    s_new = np.linspace(0.0, total, n)
    x = np.interp(s_new, s, xy[:, 0])
    y = np.interp(s_new, s, xy[:, 1])
    return np.stack([x, y], axis=1)


def extend_polyline(xy: np.ndarray, length: float, at_start: bool) -> np.ndarray:
    """Linearly extend the polyline by `length`, preserving local vertex spacing.

    Same behavior as `extend_path_linearly` (utils_coordinate_system.py:21-51):
    new points continue the first/last segment direction at that segment's
    spacing.
    """
    if at_start:
        p1, p2 = xy[0], xy[1]
    else:
        p1, p2 = xy[-2], xy[-1]
    delta = p2 - p1
    dist = float(np.linalg.norm(delta))
    if dist == 0.0:
        return xy
    n_new = int(length / dist)
    if n_new == 0:
        return xy
    i = np.arange(1, n_new + 1)[:, None]
    if at_start:
        pts = p1[None, :] - i * delta[None, :]
        return np.vstack([pts[::-1], xy])
    pts = p2[None, :] + i * delta[None, :]
    return np.vstack([xy, pts])


def smooth_polyline(
    xy: np.ndarray, point_deviation: float = 0.15, step: float = 1.0
) -> np.ndarray:
    """Smoothing-spline regularization of a reference path.

    The analog of `smooth_ref_path` (utils_coordinate_system.py:110-134), but
    with a *smoothing* spline (residual budget `point_deviation` per vertex)
    instead of an interpolating one: route centerlines concatenated from
    sparse lanelet vertices produce spline wiggle under s=0 interpolation,
    which downstream turns into curvature-rate noise that rejects every
    candidate trajectory.
    """
    from scipy.interpolate import splev, splprep

    _, idx = np.unique(xy, axis=0, return_index=True)
    xy = xy[np.sort(idx)]
    # uniform spacing first so the spline residual budget is spent evenly
    xy = resample_polyline(xy, step)
    if len(xy) < 4:
        return xy
    tck, u = splprep(xy.T, u=None, k=3, s=len(xy) * point_deviation**2)
    u_new = np.linspace(np.min(u), np.max(u), 4 * len(xy))
    x_new, y_new = splev(u_new, tck, der=0)
    out = np.stack([x_new, y_new], axis=1)
    _, idx = np.unique(out, axis=0, return_index=True)
    return out[np.sort(idx)]


def _savgol(y: np.ndarray, window: int, poly: int = 3) -> np.ndarray:
    """Savitzky-Golay smoothing (scipy) clamped to the array length."""
    from scipy.signal import savgol_filter

    n = len(y)
    w = min(window if window % 2 == 1 else window + 1, n if n % 2 == 1 else n - 1)
    if w <= poly + 1:
        return y
    return savgol_filter(y, w, poly, axis=0)


def prepare_reference_path(
    xy: np.ndarray,
    *,
    resample_step: float = 0.25,
    extension: float = 30.0,
    smooth: bool = False,
    dtype=np.float64,
) -> RefPathTable:
    """Full host-side pipeline: raw route polyline → `RefPathTable`.

    Extension at both ends, optional smoothing and the table computation in
    one call.  The result is a NamedTuple of NumPy arrays; the planner turns
    its fields into tensors on its device.
    """
    xy = np.asarray(xy, dtype=np.float64)
    _, idx = np.unique(xy, axis=0, return_index=True)
    xy = xy[np.sort(idx)]
    if smooth:
        xy = smooth_polyline(xy)
    if extension > 0.0:
        xy = extend_polyline(xy, extension, at_start=True)
        xy = extend_polyline(xy, extension, at_start=False)
    if resample_step <= 0.0:
        resample_step = 0.25
    xy = resample_polyline(xy, resample_step)

    # resample onto an *exactly uniform* s grid FIRST (see RefPathTable:
    # uniform spacing turns segment lookup into arithmetic on device)
    s_raw = polyline_pathlength(xy)
    n = len(s_raw)
    s_u = np.linspace(0.0, s_raw[-1], n)
    xy = np.stack(
        [np.interp(s_u, s_raw, xy[:, 0]), np.interp(s_u, s_raw, xy[:, 1])], axis=1
    )

    # κ and dκ/ds from Savitzky-Golay-filtered derivatives: finite differences
    # at resample_step scale amplify sub-vertex noise into curvature-rate
    # spikes that reject every candidate (the C++ ccosy smooths internally too)
    ds = s_u[1] - s_u[0] if n > 1 else 1.0
    window = max(int(round(5.0 / max(ds, 1e-6))), 5)  # ~5 m smoothing support
    x_s = _savgol(np.gradient(xy[:, 0], ds), window)
    y_s = _savgol(np.gradient(xy[:, 1], ds), window)
    theta = np.unwrap(np.arctan2(y_s, x_s))
    x_ss = _savgol(np.gradient(x_s, ds), window)
    y_ss = _savgol(np.gradient(y_s, ds), window)
    denom = np.maximum((x_s * x_s + y_s * y_s) ** 1.5, 1e-12)
    kappa = (x_s * y_ss - y_s * x_ss) / denom
    kappa_d = _savgol(np.gradient(kappa, ds), window)
    kappa_dd = np.gradient(kappa_d, ds)

    return RefPathTable(
        xy=xy.astype(dtype),
        s=s_u.astype(dtype),
        theta=theta.astype(dtype),
        kappa=kappa.astype(dtype),
        kappa_d=kappa_d.astype(dtype),
        kappa_dd=kappa_dd.astype(dtype),
    )
