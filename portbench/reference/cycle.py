"""The replanning cycle in plain PyTorch: (A, M, 13) matrices → selection.

Frozen copies (commit eab69ff) of the arithmetic of
`frenetix_tpu_torch/ops/polynomials.py`, `ops/kinematics.py::
rollout_candidates` (time-domain lateral polynomial, quartic longitudinal),
`geometry/frenet.py::interp_ref_tables`, `ops/costs.py` (the terms the
configurations weight), `ops/collision.py` (`prediction_collisions`,
`road_departure_corridor`) and `planner/core.py::evaluate_cycle`'s
selection.  The table lookup is a plain gather and lerp (no kernel), over
each agent's own table.  Nothing here imports the program.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

EPS = 1e-5
MOVING = 0.001          # m/s: a candidate's heading follows its path above this speed
TWO_PI = 6.283185307179586
BIG = 1e15

COST_TERMS = ("acceleration", "jerk", "lateral_jerk", "longitudinal_jerk",
              "orientation_offset", "path_length", "lane_center_offset",
              "velocity_offset", "velocity", "distance_to_reference_path",
              "distance_to_obstacles", "prediction", "responsibility")
# the terms this reference computes; a configuration that weights another
# term is refused (`cost_terms`)
COMPUTED = ("lateral_jerk", "longitudinal_jerk", "velocity_offset",
            "distance_to_reference_path", "prediction")


class Vehicle(NamedTuple):
    length: float
    width: float
    mass: float
    wheelbase: float
    wb_rear_axle: float
    a_max: float
    v_max: float
    v_switch: float
    delta_max: float
    v_delta_max: float
    kappa_dot_max: float


class Tables(NamedTuple):
    """One agent's reference tables as tensors."""

    s: torch.Tensor        # (R,)
    cols: torch.Tensor     # (R, 7): theta, kappa, kappa_d, x, y, d_lo, d_hi


class Preds(NamedTuple):
    means: torch.Tensor         # (O, T, 2)
    inv_covs: torch.Tensor      # (O, T, 2, 2)
    covs: torch.Tensor          # (O, T, 2, 2)
    orientations: torch.Tensor  # (O, T)
    velocities: torch.Tensor    # (O, T)
    lengths: torch.Tensor       # (O,)
    widths: torch.Tensor        # (O,)
    valid: torch.Tensor         # (O, T) bool


# ---------------------------------------------------------------- polynomials
def quartic(xs, vxs, axs, v_target, T):
    c1 = v_target - vxs - axs * T
    c2 = -axs
    inv = 1.0 / T
    inv2 = inv * inv
    a3 = c1 * inv2 - c2 * (inv / 3.0)
    a4 = -0.5 * c1 * inv2 * inv + 0.25 * c2 * inv2
    return torch.stack([xs, vxs, 0.5 * axs, a3, a4, torch.zeros_like(T)], dim=-1)


def quintic(xs, vxs, axs, xe, vxe, axe, T):
    T2 = T * T
    b0 = xe - xs - vxs * T - 0.5 * axs * T2
    b1 = vxe - vxs - axs * T
    b2 = axe - axs
    inv = 1.0 / T
    inv2 = inv * inv
    inv3 = inv2 * inv
    a3 = 0.5 * (20.0 * b0 - 8.0 * b1 * T + b2 * T2) * inv3
    a4 = 0.5 * (-30.0 * b0 + 14.0 * b1 * T - 2.0 * b2 * T2) * inv3 * inv
    a5 = 0.5 * (12.0 * b0 - 6.0 * b1 * T + b2 * T2) * inv3 * inv2
    return torch.stack([xs, vxs, 0.5 * axs, a3, a4, a5], dim=-1)


def _c(coeffs, i):
    return coeffs[..., i:i + 1]


def position(c, tau):
    return _c(c, 0) + tau * (_c(c, 1) + tau * (_c(c, 2) + tau * (
        _c(c, 3) + tau * (_c(c, 4) + tau * _c(c, 5)))))


def velocity(c, tau):
    return _c(c, 1) + tau * (2.0 * _c(c, 2) + tau * (3.0 * _c(c, 3) + tau * (
        4.0 * _c(c, 4) + tau * 5.0 * _c(c, 5))))


def acceleration(c, tau):
    return 2.0 * _c(c, 2) + tau * (6.0 * _c(c, 3) + tau * (12.0 * _c(c, 4)
                                                         + tau * 20.0 * _c(c, 5)))


def squared_jerk(c, t):
    a3, a4, a5 = c[..., 3], c[..., 4], c[..., 5]
    return (36.0 * a3 * a3 * t + 144.0 * a3 * a4 * t ** 2
            + (240.0 * a3 * a5 + 192.0 * a4 * a4) * t ** 3
            + 720.0 * a4 * a5 * t ** 4 + 720.0 * a5 * a5 * t ** 5)


# ------------------------------------------------------------------- rollout
def _lookup(tab: Tables, s, anchor, window):
    """The 7 table columns at arclengths s (M, N+1), and the in-domain mask,
    with the lookup window of `window` rows anchored at `anchor`."""
    ds = tab.s[1] - tab.s[0]
    r = tab.s.shape[0]
    idx = torch.clamp(torch.floor(s / ds).long(), 0, r - 2)
    lam = s / ds - idx.to(s.dtype)
    in_dom = (s >= tab.s[0]) & (s <= tab.s[-1])
    if window and window < r:
        offset = torch.clamp(torch.floor(anchor / ds).long() - window // 8, 0, r - window)
        local = idx - offset
        in_dom = in_dom & (local >= 0) & (local <= window - 2)
        idx = offset + torch.clamp(local, 0, window - 2)
    lo = tab.cols[idx]                  # (M, N+1, 7)
    hi = tab.cols[idx + 1]
    lam = lam[..., None]
    return (1 - lam) * lo + lam * hi, in_dom


def _carry_theta(active, theta_active, theta_init):
    n1 = active.shape[-1]
    seeded = torch.where(active, theta_active, theta_init)
    seen = active.clone()
    seen[..., 0] = True
    steps = torch.arange(n1, device=active.device).expand_as(active)
    last = torch.cummax(torch.where(seen, steps, 0), dim=-1).values
    return torch.gather(seeded, -1, last)


def rollout(matrix, tab: Tables, veh: Vehicle, x0_orientation, *, dt, n_steps,
            window):
    """States, feasibility and the 11-slot infeasibility flags of one
    agent's (M, 13) candidates over N + 1 steps (not low-velocity mode)."""
    dtype, device = matrix.dtype, matrix.device
    m, n1 = matrix.shape[0], n_steps + 1
    t1 = matrix[:, 1]
    s0, ss0, sss0, ss1 = matrix[:, 2], matrix[:, 3], matrix[:, 4], matrix[:, 5]
    d0, dd0, ddd0 = matrix[:, 7], matrix[:, 8], matrix[:, 9]
    d1, dd1, ddd1 = matrix[:, 10], matrix[:, 11], matrix[:, 12]

    c_lon = quartic(s0, ss0, sss0, ss1, t1)
    tgrid = torch.arange(n1, dtype=dtype, device=device) * dt
    traj_len = torch.clamp(torch.round(t1 / dt).long() + 1, 2, n1)
    t_end = (traj_len - 1).to(dtype) * dt
    inside = tgrid < traj_len[:, None].to(dtype) * dt
    tau = torch.minimum(tgrid, t_end[:, None])
    s_end = position(c_lon, t_end[:, None])[:, 0]
    v_end = velocity(c_lon, t_end[:, None])[:, 0]
    s = torch.where(inside, position(c_lon, tau),
                    s_end[:, None] + (tgrid - t_end[:, None]) * v_end[:, None])
    s_vel = torch.where(inside, velocity(c_lon, tau), v_end[:, None])
    sa = acceleration(c_lon, tau)
    s_acc = torch.where(inside, sa, torch.zeros_like(sa))

    c_lat = quintic(d0, dd0, ddd0, d1, dd1, ddd1, t1)
    zero = torch.zeros((), dtype=dtype, device=device)
    d = position(c_lat, tau)
    d_vel = torch.where(inside, velocity(c_lat, tau), zero)
    d_acc = torch.where(inside, acceleration(c_lat, tau), zero)

    slot = torch.zeros((m, 11), dtype=torch.bool, device=device)
    neg = torch.any(s_vel < -EPS, dim=-1)
    slot[:, 10] = neg
    slot[:, 2] = neg
    slot[:, 1] = torch.any(torch.abs(s_acc) > veh.a_max, dim=-1)
    s_vel = torch.where(torch.abs(s_vel) < EPS, zero, s_vel)

    moving = s_vel > MOVING
    one = torch.ones((), dtype=dtype, device=device)
    dp = torch.where(moving, d_vel / torch.where(moving, s_vel, one), zero)
    dpp = torch.where(moving, (d_acc - dp * s_acc)
                      / torch.where(moving, s_vel * s_vel, one), zero)

    cols, in_dom = _lookup(tab, s, s0[0], window)
    theta_lerp, k_r, k_r_d = cols[..., 0], cols[..., 1], cols[..., 2]
    alpha = torch.fmod(theta_lerp, TWO_PI)
    slot[:, 3] = torch.any(~in_dom, dim=-1)

    theta_cl_pt = torch.atan2(dp, torch.ones_like(dp))
    theta_gl_pt = theta_cl_pt + alpha
    theta_init = torch.as_tensor(x0_orientation, dtype=dtype, device=device).expand(m, 1)
    theta_gl = torch.where(moving, theta_gl_pt, _carry_theta(moving, theta_gl_pt,
                                                             theta_init))
    theta_cl = torch.where(moving, theta_cl_pt, theta_gl - alpha)

    one_krd = 1.0 - k_r * d
    cos_t = torch.cos(theta_cl)
    tan_t = torch.tan(theta_cl)
    ratio = cos_t / one_krd
    kappa = (dpp + (k_r * dp + k_r_d * d) * tan_t) * cos_t * ratio * ratio + ratio * k_r
    v = s_vel * (one_krd / cos_t)
    a = s_acc * (one_krd / cos_t) + (s_vel * s_vel / cos_t) * (
        one_krd * tan_t * (kappa * (one_krd / cos_t) - k_r) - (k_r_d * d + k_r * dp))

    kappa_max = math.tan(veh.delta_max) / veh.wheelbase
    slot[:, 4] = torch.any(v < -EPS, dim=-1)
    slot[:, 5] = torch.any(torch.abs(kappa) > kappa_max, dim=-1)
    zcol = torch.zeros((m, 1), dtype=dtype, device=device)
    yaw_rate = torch.cat([zcol, torch.diff(theta_gl, dim=-1) / dt], dim=-1)
    yaw_rate = torch.round(yaw_rate * 1e5) / 1e5
    slot[:, 6] = torch.any(torch.abs(yaw_rate) > kappa_max * v, dim=-1)
    kappa_rate = torch.cat([zcol, torch.diff(kappa, dim=-1) / dt], dim=-1)
    slot[:, 7] = torch.any(torch.abs(kappa_rate) > veh.kappa_dot_max, dim=-1)
    fast = v > veh.v_switch
    a_lim = torch.where(fast, veh.a_max * veh.v_switch / torch.where(fast, v, one),
                        torch.full_like(v, veh.a_max))
    slot[:, 8] = torch.any((a < -veh.a_max) | (a > a_lim), dim=-1)

    x = cols[..., 3] - d * torch.sin(theta_lerp)
    y = cols[..., 4] + d * torch.cos(theta_lerp)
    slot[:, 9] = torch.any(~in_dom, dim=-1)
    feasible = ~torch.any(slot[:, 1:9], dim=-1)
    valid = ~(slot[:, 10] | slot[:, 9])
    slot[:, 0] = ~(feasible & valid)
    return dict(s=s, s_vel=s_vel, s_acc=s_acc, d=d, d_vel=d_vel, d_acc=d_acc, x=x, y=y,
                theta_gl=theta_gl, theta_cl=theta_cl, v=v, a=a, kappa=kappa,
                d_lo=cols[..., 5], d_hi=cols[..., 6], c_lon=c_lon, c_lat=c_lat,
                feasible=feasible, valid=valid, slots=slot)


# ---------------------------------------------------------------------- costs
def cost_terms(ro, preds: Preds, *, dt, desired_velocity, weights: dict):
    """Σ_k w_k · term_k over the weighted terms, added in COST_TERMS order."""
    unknown = [k for k, w in weights.items() if w and k not in COMPUTED]
    if unknown:
        raise ValueError(f"the reference computes no cost term {unknown}")
    terms = {}
    terms["lateral_jerk"] = squared_jerk(ro["c_lat"], dt)
    terms["longitudinal_jerk"] = squared_jerk(ro["c_lon"], dt)
    v = ro["v"]
    half = v.shape[-1] // 2
    terms["velocity_offset"] = (torch.sum(torch.abs(v[:, half:-1] - desired_velocity), -1)
                                + torch.abs((v[:, -1] - desired_velocity) ** 2))
    dd = ro["d"]
    terms["distance_to_reference_path"] = (torch.sum(torch.abs(dd), -1)
                                           + 5.0 * torch.abs(dd[:, -1])) / dd.shape[-1]
    t = min(v.shape[-1] - 1, preds.means.shape[-2] - 1)
    dx = ro["x"][:, None, 1:t + 1] - preds.means[None, :, :t, 0]
    dy = ro["y"][:, None, 1:t + 1] - preds.means[None, :, :t, 1]
    ic = preds.inv_covs[None, :, :t]
    md2 = (dx * (ic[..., 0, 0] * dx + ic[..., 0, 1] * dy)
           + dy * (ic[..., 1, 0] * dx + ic[..., 1, 1] * dy))
    inv = 1.0 / torch.clamp(md2 * md2, min=1e-12)
    terms["prediction"] = torch.sum(inv * preds.valid[None, :, :t].to(inv.dtype), dim=(-2, -1))
    total = None
    for name in COST_TERMS:
        w = weights.get(name, 0.0)
        if name in terms:
            part = terms[name] * w
            total = part if total is None else total + part
    return total


# ------------------------------------------------------------------ collision
def _obb_overlap(ca, ta, ha, cb, tb, hb):
    dx, dy = cb[..., 0] - ca[..., 0], cb[..., 1] - ca[..., 1]
    ac, as_ = torch.cos(ta), torch.sin(ta)
    bc, bs = torch.cos(tb), torch.sin(tb)
    al, aw, bl, bw = ha[..., 0], ha[..., 1], hb[..., 0], hb[..., 1]
    cd = torch.abs(ac * bc + as_ * bs)
    sd = torch.abs(as_ * bc - ac * bs)
    separated = ((torch.abs(dx * ac + dy * as_) > al + bl * cd + bw * sd)
                 | (torch.abs(dy * ac - dx * as_) > aw + bl * sd + bw * cd)
                 | (torch.abs(dx * bc + dy * bs) > bl + al * cd + aw * sd)
                 | (torch.abs(dy * bc - dx * bs) > bw + al * sd + aw * cd))
    return ~separated


def collides(ro, preds: Preds, veh: Vehicle):
    """(M,) the candidate's box at step i overlaps an obstacle at step i-1."""
    t = min(ro["x"].shape[-1] - 1, preds.means.shape[-2])
    th = ro["theta_gl"][:, 1:t + 1]
    cx = ro["x"][:, 1:t + 1] + veh.wb_rear_axle * torch.cos(th)
    cy = ro["y"][:, 1:t + 1] + veh.wb_rear_axle * torch.sin(th)
    ego_c = torch.stack([cx, cy], -1)[:, None]
    ego_h = torch.tensor([veh.length / 2.0, veh.width / 2.0], dtype=cx.dtype,
                         device=cx.device)
    obs_h = torch.stack([preds.lengths / 2.0, preds.widths / 2.0], -1)[None, :, None]
    hit = _obb_overlap(ego_c, th[:, None], ego_h, preds.means[None, :, :t],
                       preds.orientations[None, :, :t], obs_h)
    return torch.any((hit & preds.valid[None, :, :t]).flatten(-2), dim=-1)


def off_road(ro, veh: Vehicle):
    """(M,) the footprint leaves the corridor at some step."""
    sin_t, cos_t = torch.sin(ro["theta_cl"]), torch.cos(ro["theta_cl"])
    center = ro["d"] + veh.wb_rear_axle * sin_t
    ext = 0.5 * veh.length * torch.abs(sin_t) + 0.5 * veh.width * torch.abs(cos_t)
    return torch.any((center - ext < ro["d_lo"]) | (center + ext > ro["d_hi"]), dim=-1)


def select(cost, selectable):
    """(best, found): the first index of the least cost among the
    selectable candidates."""
    masked = torch.where(selectable, cost, torch.full_like(cost, BIG))
    return torch.argmin(masked, dim=-1), torch.any(selectable, dim=-1)
