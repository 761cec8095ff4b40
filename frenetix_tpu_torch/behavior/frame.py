"""The port's own copy of `frenetix_tpu/behavior/frame.py` (NumPy only).

Host-side curvilinear frame for the behavior planner.

The behavior layer is sequential control logic running per agent per step on
host; a device round-trip per projection would dominate its cost.  This small
NumPy frame wraps the same uniform-arclength tables the planner uses
(`geometry.refpath.prepare_reference_path`) and offers vectorized
(x, y) ↔ (s, d) conversions — the behavior-planner analog of the reference's
`PP_state.cl_ref_coordinate_system` (pycrccosy CurvilinearCoordinateSystem,
behavior_planner/utils/path_planner.py:267-268).
"""
from __future__ import annotations

import numpy as np

from frenetix_tpu_torch.geometry.refpath import RefPathTable, prepare_reference_path

__all__ = ["HostFrame"]


class HostFrame:
    def __init__(self, polyline: np.ndarray, smooth: bool = True):
        self.ref: RefPathTable = prepare_reference_path(
            np.asarray(polyline, dtype=np.float64), smooth=smooth, dtype=np.float64
        )
        self.xy = np.asarray(self.ref.xy)
        self.s = np.asarray(self.ref.s)
        self.theta = np.asarray(self.ref.theta)

    @property
    def length(self) -> float:
        return float(self.s[-1])

    def project(self, points) -> tuple[np.ndarray, np.ndarray]:
        """(P, 2) or (2,) points → (s, d); d > 0 left of the path.

        Closest-segment projection, identical in convention to
        `geometry.frenet.cartesian_to_frenet` but pure NumPy.
        """
        p = np.atleast_2d(np.asarray(points, dtype=np.float64))
        a, b = self.xy[:-1], self.xy[1:]
        ab = b - a
        seg_len2 = np.maximum(np.sum(ab * ab, axis=1), 1e-12)
        # (P, R-1) projections
        ap = p[:, None, :] - a[None, :, :]
        t = np.clip(np.einsum("prk,rk->pr", ap, ab) / seg_len2[None], 0.0, 1.0)
        closest = a[None] + t[..., None] * ab[None]
        dist2 = np.sum((p[:, None, :] - closest) ** 2, axis=2)
        i = np.argmin(dist2, axis=1)
        rows = np.arange(len(p))
        s = self.s[i] + t[rows, i] * (self.s[i + 1] - self.s[i])
        ab_i = ab[i]
        ap_i = p - a[i]
        cross = ab_i[:, 0] * ap_i[:, 1] - ab_i[:, 1] * ap_i[:, 0]
        d = np.sqrt(dist2[rows, i]) * np.where(cross >= 0.0, 1.0, -1.0)
        if np.ndim(points) == 1:
            return float(s[0]), float(d[0])
        return s, d

    def project_s(self, point) -> float:
        return self.project(np.asarray(point))[0]

    def to_cartesian(self, s, d=0.0) -> np.ndarray:
        """(s, d) → (x, y) via the uniform tables (idx = floor(s/ds))."""
        scalar = np.ndim(s) == 0
        s = np.atleast_1d(np.asarray(s, dtype=np.float64))
        d = np.broadcast_to(np.asarray(d, dtype=np.float64), s.shape)
        ds = self.s[1] - self.s[0]
        idx = np.clip(np.floor(s / ds).astype(int), 0, len(self.s) - 2)
        lam = np.clip(s / ds - idx, 0.0, 1.0)
        base = self.xy[idx] + lam[:, None] * (self.xy[idx + 1] - self.xy[idx])
        th = self.theta[idx] + lam * (self.theta[idx + 1] - self.theta[idx])
        normal = np.stack([-np.sin(th), np.cos(th)], axis=-1)
        out = base + d[:, None] * normal
        return out[0] if scalar else out
