"""Batched rollout: sampling matrix → Frenet states → Cartesian states →
kinematic feasibility masks.

PyTorch port of `frenetix_tpu/ops/kinematics.py`.  One pass over the whole
(M, 13) candidate batch produces (M, N+1) state tensors and (M,) masks; the
reference-table lookup goes through the K1 kernel.  On the card the rollout
is kernel K2 around K1 (`ops.rollout_kernel`, three launches); its plain
twin `rollout_candidates_plain` runs on the CPU.

Every tensor may carry leading agent axes B: the matrix is (B..., M, 13),
the reference tables (B..., R, ...), `x0_orientation` (B...), and all outputs
start with B.  Every operation is elementwise or reduces the last axis only,
so an agent's slice of a batched rollout equals its rollout alone; the table
lookup of the whole batch is one kernel launch.

Sampling-matrix columns:

    0: t0   1: t1    2: s0    3: ss0   4: sss0  5: ss1  6: sss1
    7: d0   8: dd0   9: ddd0  10: d1   11: dd1  12: ddd1

Infeasibility histogram slots:

    0 total infeasible/invalid      6 yaw-rate constraint
    1 |s̈| > a_max pre-check         7 curvature-rate constraint
    2 ṡ < -eps pre-check            8 acceleration constraint
    3 s beyond reference path       9 out of projection domain
    4 v < -eps                     10 negative ṡ (validity)
    5 curvature constraint
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from frenetix_tpu_torch.geometry import frenet as fr
from frenetix_tpu_torch.ops import polynomials as poly
from frenetix_tpu_torch.ops import rollout_kernel

__all__ = ["VehicleParams", "Rollout", "rollout_candidates", "rollout_candidates_plain"]

_EPS = 1e-5


class VehicleParams(NamedTuple):
    """Kinematic vehicle limits (BMW 320i defaults, as in the JAX package)."""

    length: float = 4.508
    width: float = 1.610
    mass: float = 1475.0
    wheelbase: float = 2.578
    wb_rear_axle: float = 1.422
    a_max: float = 11.5
    v_max: float = 50.8
    v_switch: float = 7.319
    delta_max: float = 1.023
    v_delta_max: float = 0.4
    kappa_dot_max: float = 0.4


class Rollout(NamedTuple):
    """All per-candidate state tensors of one cycle; (M, N+1) unless noted."""

    s: torch.Tensor
    s_vel: torch.Tensor
    s_acc: torch.Tensor
    d: torch.Tensor
    d_vel: torch.Tensor
    d_acc: torch.Tensor
    x: torch.Tensor
    y: torch.Tensor
    theta_gl: torch.Tensor
    theta_cl: torch.Tensor
    v: torch.Tensor
    a: torch.Tensor
    kappa_gl: torch.Tensor
    kappa_dot: torch.Tensor
    extras: object            # tuple of K (M, N+1) extra table columns, or None
    coeffs_lon: torch.Tensor  # (M, 6)
    coeffs_lat: torch.Tensor  # (M, 6)
    traj_len: torch.Tensor    # (M,) int32 — valid samples before extension
    feasible: torch.Tensor    # (M,) bool
    valid: torch.Tensor       # (M,) bool
    inf_slots: torch.Tensor   # (M, 11) bool — violated slots per candidate

    @property
    def histogram(self) -> torch.Tensor:
        """(…, 11) infeasibility histogram, the sum of `inf_slots` over the
        candidate axis (slot 0 = total count); leading agent axes stay."""
        return torch.sum(self.inf_slots, dim=-2)


def _carry_forward_theta(active, theta_active, theta_init):
    """θ_gl for standstill steps: the value at the last active step so far,
    or the initial orientation when no step was active yet.  Step 0 always
    counts as seen (seeded with θ_init when inactive), so a running maximum
    of the last seen step index, then a gather, carries the value forward."""
    n1 = active.shape[-1]
    seeded = torch.where(active, theta_active, theta_init[..., None])
    seen = active.clone()
    seen[..., 0] = True
    steps = torch.arange(n1, device=active.device).expand_as(active)
    last_seen = torch.cummax(torch.where(seen, steps, 0), dim=-1).values
    return torch.gather(seeded, -1, last_seen)


def rollout_candidates(
    matrix: torch.Tensor,
    ref,
    params: VehicleParams,
    *,
    dt: float,
    n_steps: int,
    low_vel_mode: bool,
    x0_orientation,
    quintic_lon: bool = False,
    extra_ref_tables=None,
    table_window: int = 0,
) -> Rollout:
    """Evaluate all candidates of an (M, 13) sampling matrix, or of a
    (B..., M, 13) stack of them against (B..., R, ...) tables (or one
    (R, ...) table shared by all).

    low_vel_mode plans the lateral polynomial over arclength; quintic_lon
    treats column 5 as the end position s1 (stopping mode);
    `table_window` > 0 restricts the table lookup to a window of that many
    rows anchored at s0 (see geometry.frenet.interp_ref_tables).

    CPU tensors run the plain twin `rollout_candidates_plain`; anything else
    goes to kernel K2 (`ops.rollout_kernel.rollout_fields`), which raises on
    what it does not take."""
    tensors = [matrix, *ref[:5]] + ([extra_ref_tables] if extra_ref_tables is not None
                                    else [])
    kw = dict(dt=dt, n_steps=n_steps, low_vel_mode=low_vel_mode,
              x0_orientation=x0_orientation, quintic_lon=quintic_lon,
              extra_ref_tables=extra_ref_tables, table_window=table_window)
    if all(t.device.type == "cpu" for t in tensors):
        return rollout_candidates_plain(matrix, ref, params, **kw)
    return Rollout(**rollout_kernel.rollout_fields(matrix, ref, params, **kw))


def rollout_candidates_plain(
    matrix: torch.Tensor,
    ref,
    params: VehicleParams,
    *,
    dt: float,
    n_steps: int,
    low_vel_mode: bool,
    x0_orientation,
    quintic_lon: bool = False,
    extra_ref_tables=None,
    table_window: int = 0,
) -> Rollout:
    """Plain PyTorch twin of kernel K2, the rollout on the CPU (arguments as
    `rollout_candidates`); on the card it runs as ~335 elementwise kernels
    and K1, and K2 equals it bitwise."""
    dtype = matrix.dtype
    device = matrix.device
    rows = matrix.shape[:-1]          # (B..., M)
    n1 = n_steps + 1

    t1 = matrix[..., 1]
    s0, ss0, sss0 = matrix[..., 2], matrix[..., 3], matrix[..., 4]
    ss1, sss1 = matrix[..., 5], matrix[..., 6]
    d0, dd0, ddd0 = matrix[..., 7], matrix[..., 8], matrix[..., 9]
    d1, dd1, ddd1 = matrix[..., 10], matrix[..., 11], matrix[..., 12]

    # ---- longitudinal polynomial over the fixed time grid ------------------
    if quintic_lon:
        coeffs_lon = poly.quintic_coeffs(s0, ss0, sss0, ss1, torch.zeros_like(ss1),
                                         sss1, t1)
    else:
        coeffs_lon = poly.quartic_coeffs(s0, ss0, sss0, ss1, t1)

    tgrid = torch.arange(n1, dtype=dtype, device=device) * dt
    # round half to even, as jnp.round
    traj_len = torch.clamp(torch.round(t1 / dt).to(torch.int32) + 1, 2, n1)
    t_end = (traj_len - 1).to(dtype) * dt
    step_mask = tgrid < traj_len[..., None].to(dtype) * dt

    tau = torch.minimum(tgrid, t_end[..., None])
    s_in = poly.poly_position(coeffs_lon, tau)
    sv_in = poly.poly_velocity(coeffs_lon, tau)
    sa_in = poly.poly_acceleration(coeffs_lon, tau)

    # constant-velocity extension past t1
    s_end = poly.poly_position(coeffs_lon, t_end[..., None])[..., 0]
    v_end = poly.poly_velocity(coeffs_lon, t_end[..., None])[..., 0]
    s_ext = s_end[..., None] + (tgrid - t_end[..., None]) * v_end[..., None]
    s = torch.where(step_mask, s_in, s_ext)
    s_vel = torch.where(step_mask, sv_in, v_end[..., None])
    s_acc = torch.where(step_mask, sa_in, torch.zeros_like(sa_in))

    # ---- lateral polynomial (time, or arclength in low-velocity mode) ------
    if low_vel_mode:
        span = s_end - s0
        lat_T = torch.where(span > 0.0, span, t1)
        tau_lat = torch.where(step_mask, s - s0[..., None], span[..., None])
    else:
        lat_T = t1
        tau_lat = tau
    coeffs_lat = poly.quintic_coeffs(d0, dd0, ddd0, d1, dd1, ddd1, lat_T)
    d = poly.poly_position(coeffs_lat, tau_lat)
    zero = torch.zeros((), dtype=dtype, device=device)
    d_vel = torch.where(step_mask, poly.poly_velocity(coeffs_lat, tau_lat), zero)
    d_acc = torch.where(step_mask, poly.poly_acceleration(coeffs_lat, tau_lat), zero)

    # ---- validity / pre-feasibility ----------------------------------------
    slot = torch.zeros(rows + (11,), dtype=torch.bool, device=device)
    neg_svel = torch.any(s_vel < -_EPS, dim=-1)
    slot[..., 10] = neg_svel
    slot[..., 2] = neg_svel
    slot[..., 1] = torch.any(torch.abs(s_acc) > params.a_max, dim=-1)
    s_vel = torch.where(torch.abs(s_vel) < _EPS, zero, s_vel)

    # ---- Werling A.8 transform ---------------------------------------------
    moving = s_vel > 0.001
    if low_vel_mode:
        dp = d_vel
        dpp = d_acc
    else:
        one = torch.ones((), dtype=dtype, device=device)
        # the inner where keeps inf/NaN out of the masked lanes
        dp = torch.where(moving, d_vel / torch.where(moving, s_vel, one), zero)
        ddot = d_acc - dp * s_acc
        dpp = torch.where(moving, ddot / torch.where(moving, s_vel * s_vel, one), zero)

    tabs = fr.interp_ref_tables(
        ref, s, extra_tables=extra_ref_tables,
        window_rows=table_window if table_window else None,
        window_anchor=s0[..., 0] if table_window else None,
    )
    in_dom = tabs["in_domain"]
    slot[..., 3] = torch.any(~in_dom, dim=-1)
    alpha = tabs["alpha"]
    k_r = tabs["k_r"]
    k_r_d = tabs["k_r_d"]

    theta_cl_pt = torch.atan2(dp, torch.ones_like(dp))
    theta_gl_pt = theta_cl_pt + alpha
    if low_vel_mode:
        theta_cl = theta_cl_pt
        theta_gl = theta_gl_pt
    else:
        x0_theta = torch.as_tensor(x0_orientation, dtype=dtype,
                                   device=device)[..., None].expand(rows)
        theta_gl_hold = _carry_forward_theta(moving, theta_gl_pt, x0_theta)
        theta_gl = torch.where(moving, theta_gl_pt, theta_gl_hold)
        theta_cl = torch.where(moving, theta_cl_pt, theta_gl - alpha)

    one_krd = 1.0 - k_r * d
    cos_t = torch.cos(theta_cl)
    tan_t = torch.tan(theta_cl)
    cos_ratio = cos_t / one_krd

    kappa_gl = (dpp + (k_r * dp + k_r_d * d) * tan_t) * cos_t * cos_ratio * cos_ratio \
        + cos_ratio * k_r
    v = s_vel * (one_krd / cos_t)
    a = s_acc * (one_krd / cos_t) + (s_vel * s_vel / cos_t) * (
        one_krd * tan_t * (kappa_gl * (one_krd / cos_t) - k_r) - (k_r_d * d + k_r * dp)
    )

    # ---- constraint masks --------------------------------------------------
    kappa_max = math.tan(params.delta_max) / params.wheelbase
    slot[..., 4] = torch.any(v < -_EPS, dim=-1)
    slot[..., 5] = torch.any(torch.abs(kappa_gl) > kappa_max, dim=-1)

    zeros_col = torch.zeros(rows + (1,), dtype=dtype, device=device)
    yaw_rate = torch.cat([zeros_col, torch.diff(theta_gl, dim=-1) / dt], dim=-1)
    yaw_rate_r = torch.round(yaw_rate * 1e5) / 1e5      # round(yaw_rate, 5)
    slot[..., 6] = torch.any(torch.abs(yaw_rate_r) > kappa_max * v, dim=-1)

    kappa_dot_chk = torch.cat([zeros_col, torch.diff(kappa_gl, dim=-1) / dt], dim=-1)
    slot[..., 7] = torch.any(torch.abs(kappa_dot_chk) > params.kappa_dot_max, dim=-1)

    fast = v > params.v_switch
    a_max_v = torch.where(
        fast,
        params.a_max * params.v_switch / torch.where(fast, v, torch.ones_like(v)),
        torch.full_like(v, params.a_max),
    )
    slot[..., 8] = torch.any((a < -params.a_max) | (a > a_max_v), dim=-1)

    # ---- Cartesian positions: ref(s) + d·normal(θ_lerp) --------------------
    theta_lerp = tabs["theta_lerp"]
    x = tabs["x"] - d * torch.sin(theta_lerp)
    y = tabs["y"] + d * torch.cos(theta_lerp)
    slot[..., 9] = torch.any(~in_dom, dim=-1)

    # kappa_dot output column: [0, diff(kappa_gl)] without the /dt
    kappa_dot_out = torch.cat([zeros_col, torch.diff(kappa_gl, dim=-1)], dim=-1)

    feasible = ~torch.any(slot[..., 1:9], dim=-1)
    valid = ~(slot[..., 10] | slot[..., 9])
    slot[..., 0] = ~(feasible & valid)

    return Rollout(
        s=s, s_vel=s_vel, s_acc=s_acc, d=d, d_vel=d_vel, d_acc=d_acc,
        x=x, y=y, theta_gl=theta_gl, theta_cl=theta_cl, v=v, a=a,
        kappa_gl=kappa_gl, kappa_dot=kappa_dot_out, extras=tabs["extras"],
        coeffs_lon=coeffs_lon, coeffs_lat=coeffs_lat,
        traj_len=traj_len, feasible=feasible, valid=valid, inf_slots=slot,
    )
