"""Curvilinear initial-state computation (Werling Eqs. A.3 / A.5).

PyTorch port of `frenetix_tpu/planner/initial_state.py`:

- `compute_initial_state`, the tensor form, for a batch of agents at once
  (the JAX package vmaps its function over agents; here the states and the
  reference tables carry leading agent axes).  The θ, κ and κ' reads at
  (idx, λ) go through K1 (`geometry.frenet.interp_columns`): one launch on
  the stacked (A·R, 3) table for all agents.
- `compute_initial_state_np`, the host NumPy form for one state per cycle,
  a copy of the JAX function (the host planner uses it: a device round trip
  would cost more than the math).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from frenetix_tpu_torch.geometry import frenet as fr

__all__ = ["CartesianState", "compute_initial_state", "compute_initial_state_np"]


class CartesianState(NamedTuple):
    """Planner state at the rear axle: floats for `compute_initial_state_np`,
    or tensors of one batch shape (B...) for `compute_initial_state`."""

    x: float
    y: float
    orientation: float
    velocity: float
    acceleration: float
    steering_angle: float
    yaw_rate: float


def compute_initial_state(ref, state: CartesianState, wheelbase, low_vel_mode: bool):
    """Cartesian states → curvilinear (x0_lon, x0_lat) triples, as tensors.

    `ref` is a RefPathTable of tensors, (R,) fields or with leading agent
    axes (B..., R); the fields of `state` are tensors of shape (B...) (or
    numbers for one agent).  Returns ((B..., 3) (s, ṡ, s̈), (B..., 3)
    (d, ḋ, d̈)); in low-velocity mode the lateral derivatives are with
    respect to arclength.  Unlike the NumPy form it does not raise on a
    negative curvilinear velocity (the JAX tensor form does not either)."""
    def tensor(v):
        return torch.as_tensor(v, dtype=ref.s.dtype, device=ref.s.device)

    x, y, orientation, velocity, acceleration, steering = (
        tensor(v) for v in (state.x, state.y, state.orientation, state.velocity,
                             state.acceleration, state.steering_angle))
    s, d = fr.cartesian_to_frenet(ref, x, y)
    idx, lam, _ = fr.segment_index(ref.s, s)
    tables = torch.stack([ref.theta, ref.kappa, ref.kappa_d], dim=-1)   # (B..., R, 3)
    theta_r, kr, kr_d = fr.interp_columns(tables, idx, lam)

    theta_cl = orientation - fr.wrap_valid_orientation(theta_r)
    kappa_0 = torch.tan(steering) / wheelbase

    cos_t = torch.cos(theta_cl)
    tan_t = torch.tan(theta_cl)
    one_krd = 1.0 - kr * d

    d_p = one_krd * tan_t
    d_pp = -(kr_d * d + kr * d_p) * tan_t + (one_krd / (cos_t * cos_t)) * (
        kappa_0 * one_krd / cos_t - kr
    )

    s_velocity = velocity * cos_t / one_krd
    s_acceleration = acceleration - (s_velocity**2 / cos_t) * (
        one_krd * tan_t * (kappa_0 * one_krd / cos_t - kr) - (kr_d * d + kr * d_p)
    )
    s_acceleration = s_acceleration / (one_krd / cos_t)

    if low_vel_mode:
        d_velocity = d_p
        d_acceleration = d_pp
    else:
        d_velocity = velocity * torch.sin(theta_cl)
        d_acceleration = s_acceleration * d_p + s_velocity**2 * d_pp

    x0_lon = torch.stack([s, s_velocity, s_acceleration], dim=-1)
    x0_lat = torch.stack([d, d_velocity, d_acceleration], dim=-1)
    return x0_lon, x0_lat


def compute_initial_state_np(ref_np, state, wheelbase: float, low_vel_mode: bool):
    """Host NumPy twin of `compute_initial_state` for the per-cycle scalar case
    (one state; a device round-trip would cost more than the math).

    `state` needs fields x, y, orientation, velocity, acceleration,
    steering_angle.  Raises ValueError when the state cannot be projected, like
    the reference (planner.py:574-578, 606-608).
    """
    xy = np.asarray(ref_np.xy, dtype=np.float64)
    ref_s = np.asarray(ref_np.s, dtype=np.float64)
    p = np.array([float(state.x), float(state.y)])

    a = xy[:-1]
    b = xy[1:]
    ab = b - a
    seg_len2 = np.maximum(np.sum(ab * ab, axis=1), 1e-12)
    t = np.clip(np.sum((p[None] - a) * ab, axis=1) / seg_len2, 0.0, 1.0)
    closest = a + t[:, None] * ab
    dist2 = np.sum((p[None] - closest) ** 2, axis=1)
    i = int(np.argmin(dist2))
    s = float(ref_s[i] + t[i] * (ref_s[i + 1] - ref_s[i]))
    cross = ab[i, 0] * (p[1] - a[i, 1]) - ab[i, 1] * (p[0] - a[i, 0])
    d = float(np.sqrt(dist2[i])) * (1.0 if cross >= 0 else -1.0)

    ds = ref_s[1] - ref_s[0]
    idx = int(np.clip(np.floor(s / ds), 0, len(ref_s) - 2))
    lam = s / ds - idx

    def interp(tab):
        tab = np.asarray(tab, dtype=np.float64)
        return tab[idx] + lam * (tab[idx + 1] - tab[idx])

    theta_r = interp(ref_np.theta)
    theta_r = np.fmod(theta_r, 2 * np.pi)
    theta_cl = float(state.orientation) - theta_r
    kr = interp(ref_np.kappa)
    kr_d = interp(ref_np.kappa_d)
    kappa_0 = np.tan(float(state.steering_angle)) / wheelbase

    cos_t = np.cos(theta_cl)
    tan_t = np.tan(theta_cl)
    one_krd = 1.0 - kr * d

    d_p = one_krd * tan_t
    d_pp = -(kr_d * d + kr * d_p) * tan_t + (one_krd / cos_t**2) * (
        kappa_0 * one_krd / cos_t - kr
    )

    s_velocity = float(state.velocity) * cos_t / one_krd
    if s_velocity < 0:
        raise ValueError(
            "Initial state or reference incorrect: curvilinear velocity negative"
        )
    s_acceleration = float(state.acceleration) - (s_velocity**2 / cos_t) * (
        one_krd * tan_t * (kappa_0 * one_krd / cos_t - kr) - (kr_d * d + kr * d_p)
    )
    s_acceleration /= one_krd / cos_t

    if low_vel_mode:
        d_velocity = d_p
        d_acceleration = d_pp
    else:
        d_velocity = float(state.velocity) * np.sin(theta_cl)
        d_acceleration = s_acceleration * d_p + s_velocity**2 * d_pp

    return (
        np.array([s, s_velocity, s_acceleration]),
        np.array([d, d_velocity, d_acceleration]),
    )
