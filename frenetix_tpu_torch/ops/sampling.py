"""Sampling-space construction: progressive-density grids → (M, 13) matrices.

The port's own copy of `frenetix_tpu/ops/sampling.py`: time, velocity and
lateral-position grids with the n → 2n-1 densification schedule, their
cartesian product, and the per-cycle range assembly t1 ∪ {horizon},
ss1 ∪ {current ṡ}, d1 ∪ {current d}; all other columns pinned to the current
state.

Host-side by design: grids are tiny (tens of values); the (M, 13) matrix is
assembled in NumPy, padded to a bucketed M, and copied to the device once per
cycle.  Ranges are sorted, so selection is deterministic under cost ties.
With `utils.tracing` on, the matrix build and its padding are the spans
`frenetix.sampling.matrix` and `frenetix.sampling.pad`.
"""
from __future__ import annotations

import numpy as np

from frenetix_tpu_torch.utils import tracing

__all__ = [
    "time_samples",
    "linspace_samples",
    "build_sampling_matrix",
    "pad_matrix",
    "candidate_counts",
]

# column indices of the 13-column sampling matrix
COL_T0, COL_T1, COL_S0, COL_SS0, COL_SSS0, COL_SS1, COL_SSS1 = range(7)
COL_D0, COL_DD0, COL_DDD0, COL_D1, COL_DD1, COL_DDD1 = range(7, 13)


def time_samples(t_min: float, horizon: float, dt: float, level: int) -> np.ndarray:
    """End-time grid at a density level (TimeSampling._initialization,
    sampling_matrix.py:190-195): step = int((1/(level+1))/dt)·dt, quantized to
    the planner dt, rounded to 2 decimals."""
    step_size = int((1.0 / (level + 1)) / dt)
    step_size = max(step_size, 1)
    samp = np.round(np.arange(t_min, horizon + dt, step_size * dt), 2)
    return np.unique(samp[samp <= round(horizon + dt, 2)])


def linspace_samples(minimum: float, maximum: float, level: int) -> np.ndarray:
    """n-point linspace with n = 3, 5, 9, 17, 33, ... at levels 0, 1, 2, ...
    (VelocitySampling/LateralPositionSampling, sampling_matrix.py:152-182)."""
    n = 3
    for _ in range(level):
        n = n * 2 - 1
    return np.unique(np.linspace(minimum, maximum, n))


def build_sampling_matrix(
    *,
    t1_vals: np.ndarray,
    ss1_vals: np.ndarray,
    d1_vals: np.ndarray,
    x0_lon,
    x0_lat,
    dtype=np.float64,
) -> np.ndarray:
    """Cartesian product of (t1, ss1, d1) with current-state columns pinned.

    Column layout (generate_sampling_matrix, sampling_matrix.py:93-105):
    [t0, t1, s0, ss0, sss0, ss1, sss1, d0, dd0, ddd0, d1, dd1, ddd1].
    Product iteration order matches itertools.product over (t1, ss1, d1)
    (the reference varies d fastest, then v, then t).
    """
    with tracing.span("frenetix.sampling.matrix"):
        t1_vals = np.atleast_1d(np.asarray(t1_vals, dtype))
        ss1_vals = np.atleast_1d(np.asarray(ss1_vals, dtype))
        d1_vals = np.atleast_1d(np.asarray(d1_vals, dtype))
        nt, nv, nd = len(t1_vals), len(ss1_vals), len(d1_vals)
        m = nt * nv * nd

        mat = np.zeros((m, 13), dtype)
        mat[:, COL_T1] = np.repeat(t1_vals, nv * nd)
        mat[:, COL_SS1] = np.tile(np.repeat(ss1_vals, nd), nt)
        mat[:, COL_D1] = np.tile(d1_vals, nt * nv)
        mat[:, COL_S0] = x0_lon[0]
        mat[:, COL_SS0] = x0_lon[1]
        mat[:, COL_SSS0] = x0_lon[2]
        mat[:, COL_D0] = x0_lat[0]
        mat[:, COL_DD0] = x0_lat[1]
        mat[:, COL_DDD0] = x0_lat[2]
        return mat


def pad_range(values: np.ndarray, size: int) -> np.ndarray:
    """Pad a sampling range to a static size by repeating the last value."""
    values = np.atleast_1d(values)
    if len(values) >= size:
        return values[:size]
    return np.concatenate([values, np.repeat(values[-1:], size - len(values))])


def pad_matrix(matrix: np.ndarray, bucket: int = 256):
    """Pad M up to the next multiple of `bucket` with copies of row 0.

    Padding rows are real (harmless) candidates; the valid-count mask produced
    here excludes them from selection.  Bucketing keeps the number of distinct
    jit specializations small across sampling levels.
    """
    with tracing.span("frenetix.sampling.pad"):
        m = matrix.shape[0]
        m_pad = ((m + bucket - 1) // bucket) * bucket
        if m_pad == m:
            return matrix, np.ones(m, bool)
        pad = np.repeat(matrix[:1], m_pad - m, axis=0)
        out = np.concatenate([matrix, pad], axis=0)
        mask = np.zeros(m_pad, bool)
        mask[:m] = True
        return out, mask


def candidate_counts(t_min: float, horizon: float, dt: float, levels) -> dict:
    """Candidate count per sampling level (diagnostics/benchmark sizing)."""
    out = {}
    for lvl in levels:
        nt = len(time_samples(t_min, horizon, dt, lvl)) + 1
        nv = len(linspace_samples(0.0, 1.0, lvl)) + 1
        nd = len(linspace_samples(-3.0, 3.0, lvl)) + 1
        out[lvl] = nt * nv * nd
    return out
