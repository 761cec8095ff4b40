"""Obstacle predictions → fixed-shape tensors.

PyTorch port of `frenetix_tpu/sim/prediction.py` (ground-truth and
constant-velocity modes; the NumPy part is a copy, since the JAX module sits
behind `frenetix_tpu.sim`, whose package import loads JAX).  Both modes
return host NumPy fields; `to_device` turns them into the port's
`PredictionTensors` on a device.
"""
from __future__ import annotations

import numpy as np
import torch

from frenetix_tpu_torch.ops.costs import PredictionTensors

__all__ = ["ground_truth_predictions", "constant_velocity_predictions",
           "extrapolate_constant_velocity", "to_device"]


def _enrich_orientation(means: np.ndarray, fallback: float) -> np.ndarray:
    """Finite-difference yaw along the predicted path; degenerate steps keep
    the previous orientation."""
    t = means.shape[0]
    out = np.full(t, fallback)
    prev = fallback
    for i in range(1, t):
        dx, dy = means[i] - means[i - 1]
        if dx * dx + dy * dy > 1e-8:
            prev = np.arctan2(dy, dx)
        out[i] = prev
    out[0] = out[1] if t > 1 else fallback
    return out


def ground_truth_predictions(
    scenario,
    obstacle_ids,
    current_step: int,
    horizon: int,
    *,
    cov_pos: float = 0.5,
    max_obstacles: int = 16,
    safety_margin_length: float = 0.5,
    safety_margin_width: float = 0.2,
    dtype=np.float32,
):
    """The scenario's future obstacle trajectories as means, with a fixed
    covariance; rows beyond the recorded trajectory are padded with the last
    pose and masked.  Each footprint grows by the safety margins."""
    o = max_obstacles
    means = np.zeros((o, horizon, 2), dtype)
    orientations = np.zeros((o, horizon), dtype)
    velocities = np.zeros((o, horizon), dtype)
    covs = np.tile((np.eye(2, dtype=dtype) * cov_pos)[None, None], (o, horizon, 1, 1))
    lengths = np.full(o, 4.5, dtype)
    widths = np.full(o, 2.0, dtype)
    valid = np.zeros((o, horizon), bool)

    for k, oid in enumerate(list(obstacle_ids)[:o]):
        ob = scenario.obstacles[oid]
        last_state = None
        traj_means = np.zeros((horizon, 2))
        for i in range(horizon):
            st = ob.state_at_time(current_step + 1 + i)
            if st is None:
                break
            traj_means[i] = st.position
            velocities[k, i] = st.velocity
            valid[k, i] = True
            last_state = st
        n_valid = int(valid[k].sum())
        if n_valid == 0:
            continue
        means[k, :n_valid] = traj_means[:n_valid]
        means[k, n_valid:] = traj_means[n_valid - 1]
        velocities[k, n_valid:] = velocities[k, n_valid - 1]
        st0 = ob.state_at_time(current_step)
        fb = st0.orientation if st0 is not None else (
            last_state.orientation if last_state else 0.0)
        orientations[k] = _enrich_orientation(means[k], fb)
        lengths[k] = ob.length + safety_margin_length
        widths[k] = ob.width + safety_margin_width

    inv = np.linalg.inv(covs.astype(np.float64)).astype(dtype)
    return dict(
        means=means, covs=covs, inv_covs=inv, orientations=orientations,
        velocities=velocities, lengths=lengths, widths=widths, valid=valid,
    )


def extrapolate_constant_velocity(position, orientation, velocity, horizon, dt):
    """(T, 2) straight-line means from one pose."""
    steps = np.arange(1, horizon + 1)
    heading = np.array([np.cos(orientation), np.sin(orientation)])
    return np.asarray(position)[None] + (velocity * dt * steps)[:, None] * heading[None]


def constant_velocity_predictions(
    scenario, obstacle_ids, current_step, horizon, *, dt,
    cov_pos=0.5, cov_growth=0.05, max_obstacles=16, dtype=np.float32,
):
    """Constant-velocity extrapolation; the position variance grows from
    `cov_pos` by `cov_growth` per second."""
    o = max_obstacles
    means = np.zeros((o, horizon, 2), dtype)
    orientations = np.zeros((o, horizon), dtype)
    velocities = np.zeros((o, horizon), dtype)
    covs = np.zeros((o, horizon, 2, 2), dtype)
    lengths = np.full(o, 4.5, dtype)
    widths = np.full(o, 2.0, dtype)
    valid = np.zeros((o, horizon), bool)

    steps = np.arange(1, horizon + 1)
    for k, oid in enumerate(list(obstacle_ids)[:o]):
        ob = scenario.obstacles[oid]
        st = ob.state_at_time(current_step)
        if st is None:
            continue
        means[k] = extrapolate_constant_velocity(
            st.position, st.orientation, st.velocity, horizon, dt
        )
        orientations[k] = st.orientation
        velocities[k] = st.velocity
        var = cov_pos + cov_growth * steps * dt
        covs[k, :, 0, 0] = var
        covs[k, :, 1, 1] = var
        valid[k] = True
        lengths[k] = ob.length + 0.5
        widths[k] = ob.width + 0.2

    covs_safe = covs.copy()
    covs_safe[..., 0, 0] = np.maximum(covs_safe[..., 0, 0], 1e-3)
    covs_safe[..., 1, 1] = np.maximum(covs_safe[..., 1, 1], 1e-3)
    inv = np.linalg.inv(covs_safe.astype(np.float64)).astype(dtype)
    return dict(
        means=means, covs=covs_safe, inv_covs=inv, orientations=orientations,
        velocities=velocities, lengths=lengths, widths=widths, valid=valid,
    )


def to_device(pred_dict, device: torch.device, dtype=torch.float32) -> PredictionTensors:
    """Host prediction fields → PredictionTensors on `device` (floats as
    `dtype`, the mask as bool)."""
    def f(name):
        return torch.as_tensor(np.asarray(pred_dict[name]), dtype=dtype, device=device)

    return PredictionTensors(
        means=f("means"),
        inv_covs=f("inv_covs"),
        covs=f("covs"),
        orientations=f("orientations"),
        velocities=f("velocities"),
        lengths=f("lengths"),
        widths=f("widths"),
        valid=torch.as_tensor(np.asarray(pred_dict["valid"], dtype=bool),
                              device=device),
    )
