"""Host-side inputs of a cycle, worked out again from the raw request.

Frozen copies (commit eab69ff) of `frenetix_tpu_torch/geometry/refpath.py`
(`prepare_reference_path` and the helpers it uses, without smoothing),
`geometry/corridor.py::strip_corridor` and `ops/sampling.py`
(`time_samples`, `linspace_samples`, `build_sampling_matrix`, `pad_matrix`).
They compute in float64 NumPy; nothing here imports the program.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


class RefPath(NamedTuple):
    """Reference-path tables on a uniform arclength grid (s[0] = 0)."""

    xy: np.ndarray       # (R, 2)
    s: np.ndarray        # (R,)
    theta: np.ndarray    # (R,) unwrapped
    kappa: np.ndarray    # (R,)
    kappa_d: np.ndarray  # (R,)


def _pathlength(xy):
    seg = np.linalg.norm(np.diff(xy, axis=0), axis=1)
    return np.concatenate([[0.0], np.cumsum(seg)])


def _resample(xy, step):
    s = _pathlength(xy)
    total = s[-1]
    if total <= step:
        return xy.copy()
    n = int(np.floor(total / step)) + 1
    s_new = np.linspace(0.0, total, n)
    return np.stack([np.interp(s_new, s, xy[:, 0]), np.interp(s_new, s, xy[:, 1])],
                    axis=1)


def _extend(xy, length, at_start):
    p1, p2 = (xy[0], xy[1]) if at_start else (xy[-2], xy[-1])
    delta = p2 - p1
    dist = float(np.linalg.norm(delta))
    if dist == 0.0:
        return xy
    n_new = int(length / dist)
    if n_new == 0:
        return xy
    i = np.arange(1, n_new + 1)[:, None]
    if at_start:
        return np.vstack([(p1[None, :] - i * delta[None, :])[::-1], xy])
    return np.vstack([xy, p2[None, :] + i * delta[None, :]])


def _savgol(y, window, poly=3):
    from scipy.signal import savgol_filter

    n = len(y)
    w = min(window if window % 2 == 1 else window + 1, n if n % 2 == 1 else n - 1)
    if w <= poly + 1:
        return y
    return savgol_filter(y, w, poly, axis=0)


def reference_path(xy, *, extension: float, resample_step: float = 0.25) -> RefPath:
    """Raw centerline → tables: both ends extended, resampled to a uniform
    arclength grid, heading and curvature from Savitzky-Golay-filtered
    derivatives over ~5 m."""
    xy = np.asarray(xy, dtype=np.float64)
    _, idx = np.unique(xy, axis=0, return_index=True)
    xy = xy[np.sort(idx)]
    if extension > 0.0:
        xy = _extend(xy, extension, at_start=True)
        xy = _extend(xy, extension, at_start=False)
    xy = _resample(xy, resample_step)
    s_raw = _pathlength(xy)
    n = len(s_raw)
    s_u = np.linspace(0.0, s_raw[-1], n)
    xy = np.stack([np.interp(s_u, s_raw, xy[:, 0]), np.interp(s_u, s_raw, xy[:, 1])],
                  axis=1)
    ds = s_u[1] - s_u[0]
    window = max(int(round(5.0 / max(ds, 1e-6))), 5)
    x_s = _savgol(np.gradient(xy[:, 0], ds), window)
    y_s = _savgol(np.gradient(xy[:, 1], ds), window)
    theta = np.unwrap(np.arctan2(y_s, x_s))
    x_ss = _savgol(np.gradient(x_s, ds), window)
    y_ss = _savgol(np.gradient(y_s, ds), window)
    denom = np.maximum((x_s * x_s + y_s * y_s) ** 1.5, 1e-12)
    kappa = (x_s * y_ss - y_s * x_ss) / denom
    kappa_d = _savgol(np.gradient(kappa, ds), window)
    return RefPath(xy=xy, s=s_u, theta=theta, kappa=kappa, kappa_d=kappa_d)


def strip_corridor(n_rows: int, half_width: float) -> np.ndarray:
    """(R, 2) constant drivable bounds [-half_width, half_width] in d."""
    out = np.empty((n_rows, 2))
    out[:, 0] = -half_width
    out[:, 1] = half_width
    return out


def time_samples(t_min, horizon, dt, level):
    """End times at a density level: step int((1/(level+1))/dt)·dt from
    t_min, rounded to 2 decimals, up to horizon + dt."""
    step = max(int((1.0 / (level + 1)) / dt), 1)
    samp = np.round(np.arange(t_min, horizon + dt, step * dt), 2)
    return np.unique(samp[samp <= round(horizon + dt, 2)])


def linspace_samples(lo, hi, level):
    """n = 3, 5, 9, 17, ... points at levels 0, 1, 2, ..."""
    n = 3
    for _ in range(level):
        n = n * 2 - 1
    return np.unique(np.linspace(lo, hi, n))


def sampling_matrix(t1, ss1, d1, x0_lon, x0_lat) -> np.ndarray:
    """(M, 13) product of (t1, ss1, d1), d varying fastest, the current
    state in the pinned columns [t0, t1, s0, ṡ0, s̈0, ṡ1, s̈1, d0, ḋ0, d̈0,
    d1, ḋ1, d̈1]."""
    t1, ss1, d1 = (np.atleast_1d(np.asarray(v, np.float64)) for v in (t1, ss1, d1))
    nt, nv, nd = len(t1), len(ss1), len(d1)
    mat = np.zeros((nt * nv * nd, 13))
    mat[:, 1] = np.repeat(t1, nv * nd)
    mat[:, 5] = np.tile(np.repeat(ss1, nd), nt)
    mat[:, 10] = np.tile(d1, nt * nv)
    mat[:, 2], mat[:, 3], mat[:, 4] = x0_lon
    mat[:, 7], mat[:, 8], mat[:, 9] = x0_lat
    return mat


def pad_rows(matrix: np.ndarray, bucket: int):
    """Rows padded up to a multiple of `bucket` with copies of row 0, and
    the mask of the real rows."""
    m = matrix.shape[0]
    m_pad = ((m + bucket - 1) // bucket) * bucket
    mask = np.zeros(m_pad, bool)
    mask[:m] = True
    return np.concatenate([matrix, np.repeat(matrix[:1], m_pad - m, axis=0)]), mask
