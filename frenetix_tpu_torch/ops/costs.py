"""Batched cost stack: every cost term maps the (M, N+1) rollout to (M,).

PyTorch port of `frenetix_tpu/ops/costs.py`: the 13 terms of
`COST_TERM_ORDER`, the scipy-compatible Simpson rule and the weighted total
(the K products added in COST_TERM_ORDER, or the fixed-order
Neumaier-compensated sum).

Every function accepts leading agent axes B: rollout fields (B..., M, N+1),
predictions (B..., O, T, ...), obstacle positions (B..., O, 2), lane segments
(B..., S, 2, 2) and per-agent scalars (B...).  Reductions run over trailing
axes only and the two small products (the 2×2 quadratic form of the
prediction cost, the weighted total) are written as explicit multiply-adds
in a fixed order, so an agent's slice of a batched result equals the result
of that agent alone.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from frenetix_tpu_torch.ops.polynomials import squared_jerk_integral

__all__ = [
    "PredictionTensors",
    "empty_predictions",
    "simpson_uniform",
    "quadratic_form_2x2",
    "compute_cost_terms",
    "weighted_total",
    "COST_TERM_ORDER",
]


class PredictionTensors(NamedTuple):
    """Fixed-shape obstacle predictions: O obstacles × T steps, padded, with
    a validity mask; optionally with leading agent axes."""

    means: torch.Tensor         # (..., O, T, 2)
    inv_covs: torch.Tensor      # (..., O, T, 2, 2)
    covs: torch.Tensor          # (..., O, T, 2, 2)
    orientations: torch.Tensor  # (..., O, T)
    velocities: torch.Tensor    # (..., O, T)
    lengths: torch.Tensor       # (..., O)
    widths: torch.Tensor        # (..., O)
    valid: torch.Tensor         # (..., O, T) bool

    @property
    def num_obstacles(self) -> int:
        return self.means.shape[-3]

    @property
    def horizon(self) -> int:
        return self.means.shape[-2]


def empty_predictions(n_steps: int, dtype=torch.float32,
                      device=None) -> PredictionTensors:
    """A zero-obstacle PredictionTensors with static shapes."""
    def z(shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    return PredictionTensors(
        means=z((0, n_steps, 2)),
        inv_covs=z((0, n_steps, 2, 2)),
        covs=z((0, n_steps, 2, 2)),
        orientations=z((0, n_steps)),
        velocities=z((0, n_steps)),
        lengths=z((0,)),
        widths=z((0,)),
        valid=z((0, n_steps), torch.bool),
    )


def simpson_uniform(y, dx, dim=-1):
    """Composite Simpson over uniform samples, as scipy's `simps(even='avg')`:
    an odd sample count is plain Simpson; an even count averages (Simpson on
    [0:-1] + trapezoid on the last interval) and (Simpson on [1:] +
    trapezoid on the first interval)."""
    y = torch.movedim(y, dim, -1)
    n = y.shape[-1]

    def _simpson_odd(yy):
        k = yy.shape[-1]
        if k < 3:
            return torch.sum((yy[..., :-1] + yy[..., 1:]) * 0.5 * dx, dim=-1)
        w = torch.ones((k,), dtype=yy.dtype, device=yy.device)
        w[1:-1:2] = 4.0
        w[2:-1:2] = 2.0
        return torch.sum(yy * w, dim=-1) * (dx / 3.0)

    if n % 2 == 1:
        return _simpson_odd(y)
    trap_last = 0.5 * dx * (y[..., -1] + y[..., -2])
    trap_first = 0.5 * dx * (y[..., 0] + y[..., 1])
    res1 = _simpson_odd(y[..., :-1]) + trap_last
    res2 = _simpson_odd(y[..., 1:]) + trap_first
    return 0.5 * (res1 + res2)


# ---------------------------------------------------------------------------
# individual cost terms — each maps a Rollout (+aux) to an (M,) vector
# ---------------------------------------------------------------------------


def _per_agent(value, like):
    """A per-agent scalar (B...) as a tensor that broadcasts against `like`
    (B..., M) or (B..., M, N+1)."""
    value = torch.as_tensor(value, dtype=like.dtype, device=like.device)
    return value.reshape(value.shape + (1,) * (like.dim() - value.dim()))


def acceleration_costs(ro, dt):
    """∫ a² dt."""
    return simpson_uniform(ro.a * ro.a, dt)


def jerk_costs(ro, dt):
    """∫ (da/dt)² dt over the N differences (even count → 'avg' Simpson)."""
    jerk = torch.diff(ro.a, dim=-1) / dt
    return simpson_uniform(jerk * jerk, dt)


def lateral_jerk_costs(ro, dt):
    """Closed-form squared-jerk integral of the lateral polynomial on [0, dt]."""
    return squared_jerk_integral(ro.coeffs_lat, dt)


def longitudinal_jerk_costs(ro, dt):
    return squared_jerk_integral(ro.coeffs_lon, dt)


def orientation_offset_costs(ro, dt):
    """∫ (dθ_cl/dt)² dt."""
    dtheta = torch.diff(ro.theta_cl, dim=-1) / dt
    return simpson_uniform(dtheta * dtheta, dt)


def velocity_offset_costs(ro, desired_velocity):
    """Σ_{i≥(N+1)//2}^{N-1} |v_i - v_des| + (v_N - v_des)²."""
    half = ro.v.shape[-1] // 2
    v_des = _per_agent(desired_velocity, ro.v)
    dev = torch.abs(ro.v[..., half:-1] - v_des)
    return torch.sum(dev, dim=-1) + torch.abs((ro.v[..., -1] - v_des[..., 0]) ** 2)


def distance_to_reference_path_costs(ro):
    """(Σ|d| + 5|d_N|) / (N+1)."""
    n1 = ro.d.shape[-1]
    return (torch.sum(torch.abs(ro.d), dim=-1) + 5.0 * torch.abs(ro.d[..., -1])) / n1


def path_length_costs(ro, dt):
    """∫ v dt."""
    return simpson_uniform(ro.v, dt)


def velocity_costs(ro, desired_avg_velocity):
    """|mean(v) - v_avg_target|."""
    mean_v = torch.mean(ro.v, dim=-1)
    return torch.abs(mean_v - _per_agent(desired_avg_velocity, mean_v))


def distance_to_obstacles_costs(ro, obstacle_xy, obstacle_valid):
    """Σ_obstacles Σ_steps 1/dist² to the current obstacle positions."""
    if obstacle_xy.shape[-2] == 0:
        return torch.zeros(ro.x.shape[:-1], dtype=ro.x.dtype, device=ro.x.device)
    dx = ro.x[..., None] - obstacle_xy[..., None, None, :, 0]
    dy = ro.y[..., None] - obstacle_xy[..., None, None, :, 1]
    inv = 1.0 / torch.clamp(dx * dx + dy * dy, min=1e-12)
    inv = inv * obstacle_valid[..., None, None, :].to(inv.dtype)
    return torch.sum(inv, dim=(-2, -1))


def lane_center_offset_costs(ro, lane_segments, lane_valid):
    """Mean distance to the nearest lanelet centerline segment, capped at 5."""
    if lane_segments.shape[-3] == 0:
        return torch.zeros(ro.x.shape[:-1], dtype=ro.x.dtype, device=ro.x.device)
    p = torch.stack([ro.x, ro.y], dim=-1)[..., None, :]        # (M, N+1, 1, 2)
    a = lane_segments[..., None, None, :, 0, :]                 # (1, 1, S, 2)
    b = lane_segments[..., None, None, :, 1, :]
    ab = b - a
    denom = torch.clamp(torch.sum(ab * ab, dim=-1), min=1e-9)
    t = torch.clamp(torch.sum((p - a) * ab, dim=-1) / denom, 0.0, 1.0)
    closest = a + t[..., None] * ab
    d2 = torch.sum((p - closest) ** 2, dim=-1)                 # (M, N+1, S)
    d2 = torch.where(lane_valid[..., None, None, :], d2, torch.inf)
    dist = torch.sqrt(torch.amin(d2, dim=-1))
    dist = torch.where(dist > 5.0, torch.full_like(dist, 5.0), dist)
    return torch.mean(dist, dim=-1)


def quadratic_form_2x2(dx, dy, mat):
    """Δᵀ M Δ for Δ = (dx, dy) and M (..., 2, 2) as four explicit products,
    Δx(M₀₀Δx + M₀₁Δy) + Δy(M₁₀Δx + M₁₁Δy): no library product, so the
    rounding does not depend on the batch shape."""
    return (dx * (mat[..., 0, 0] * dx + mat[..., 0, 1] * dy)
            + dy * (mat[..., 1, 0] * dx + mat[..., 1, 1] * dy))


def prediction_costs(ro, preds: PredictionTensors):
    """Inverse-Mahalanobis surrogate Σ_o Σ_{i=1..t} 1/(Δᵀ Σ⁻¹ Δ)² with
    Δ = traj_i - mean_{i-1}, t = min(N, T-1); invalid steps masked."""
    if preds.num_obstacles == 0:
        return torch.zeros(ro.x.shape[:-1], dtype=ro.x.dtype, device=ro.x.device)
    n1 = ro.x.shape[-1]
    t_traj = min(n1 - 1, preds.horizon - 1)
    mean = preds.means[..., None, :, :t_traj, :]                 # (1, O, t, 2)
    icov = preds.inv_covs[..., None, :, :t_traj, :, :]           # (1, O, t, 2, 2)
    dx = ro.x[..., None, 1 : t_traj + 1] - mean[..., 0]          # (M, O, t)
    dy = ro.y[..., None, 1 : t_traj + 1] - mean[..., 1]
    md2 = quadratic_form_2x2(dx, dy, icov)
    contrib = 1.0 / torch.clamp(md2 * md2, min=1e-12)
    contrib = contrib * preds.valid[..., None, :, :t_traj].to(contrib.dtype)
    return torch.sum(contrib, dim=(-2, -1))


COST_TERM_ORDER = (
    "acceleration",
    "jerk",
    "lateral_jerk",
    "longitudinal_jerk",
    "orientation_offset",
    "path_length",
    "lane_center_offset",
    "velocity_offset",
    "velocity",
    "distance_to_reference_path",
    "distance_to_obstacles",
    "prediction",
    "responsibility",
)


def compute_cost_terms(
    ro,
    *,
    dt: float,
    desired_velocity,
    preds: PredictionTensors,
    obstacle_xy,
    obstacle_valid,
    desired_avg_velocity=0.0,
    lane_segments=None,
    lane_valid=None,
    responsibility_cost=None,
):
    """All cost terms as an (M, K) matrix in COST_TERM_ORDER; absent inputs
    (lane segments, responsibility) give zero columns."""
    zeros = torch.zeros(ro.x.shape[:-1], dtype=ro.x.dtype, device=ro.x.device)
    terms = {
        "acceleration": acceleration_costs(ro, dt),
        "jerk": jerk_costs(ro, dt),
        "lateral_jerk": lateral_jerk_costs(ro, dt),
        "longitudinal_jerk": longitudinal_jerk_costs(ro, dt),
        "orientation_offset": orientation_offset_costs(ro, dt),
        "path_length": path_length_costs(ro, dt),
        "lane_center_offset": (
            lane_center_offset_costs(ro, lane_segments, lane_valid)
            if lane_segments is not None else zeros
        ),
        "velocity_offset": velocity_offset_costs(ro, desired_velocity),
        "velocity": velocity_costs(ro, desired_avg_velocity),
        "distance_to_reference_path": distance_to_reference_path_costs(ro),
        "distance_to_obstacles": distance_to_obstacles_costs(ro, obstacle_xy,
                                                             obstacle_valid),
        "prediction": prediction_costs(ro, preds),
        "responsibility": (responsibility_cost if responsibility_cost is not None
                           else zeros),
    }
    return torch.stack([terms[k] for k in COST_TERM_ORDER], dim=-1)


def weighted_total(cost_terms, weights, compensated=False):
    """total_m = Σ_k w_k · c_mk, the K products added one by one in
    COST_TERM_ORDER (no library product, whose summation order may change
    with the batch shape).

    `compensated=True` accumulates them with a Neumaier error term, so
    mathematically equal totals compare bitwise equal and the first-index
    tie-break of the argmin is deterministic."""
    prods = cost_terms * weights
    s = prods[..., 0]
    if not compensated:
        for k in range(1, prods.shape[-1]):
            s = s + prods[..., k]
        return s
    c = torch.zeros_like(s)
    for k in range(1, prods.shape[-1]):
        x = prods[..., k]
        t = s + x
        c = c + torch.where(torch.abs(s) >= torch.abs(x), (s - t) + x, (x - t) + s)
        s = t
    return s + c
