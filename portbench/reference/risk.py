"""The risk stack and the responsibility re-selection in plain PyTorch.

Frozen copies (commit eab69ff) of the arithmetic of
`frenetix_tpu_torch/risk/probability.py::collision_probability_fast` (3 ego
rectangles × 3 obstacle means, the bivariate-normal CDF by a 24-node
Gauss-Legendre quadrature, the 5 m gate), `risk/harm.py` (the footprint
metadata, the reduced symmetric log-reg model, the pedestrian model),
`risk/costs.py::trajectory_risks` (simplified crash angles, max over time
and obstacles), `risk/reachable_set.py::responsibility_reach_grid` and
`parallel/mesh.py::post_pass_selection` (the responsibility term only).
One agent at a time; nothing here imports the program.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference.cycle import Preds, Vehicle

_GL_X, _GL_W = np.polynomial.legendre.leggauss(24)
_GL_X = ((_GL_X + 1.0) / 2.0).tolist()
_GL_W = (_GL_W / 2.0).tolist()

LOG_REG_SYM = {"const": -4.457, "speed": 0.177, "side": 0.244, "rear": -0.431}
PEDESTRIAN = {"const": 3.164, "speed": 0.288}


def _bvn_cdf(x, y, rho):
    acc = torch.zeros_like(x)
    for node, weight in zip(_GL_X, _GL_W):
        r = rho * node
        one = 1.0 - r * r
        acc += torch.exp(-(x * x - 2.0 * r * x * y + y * y) / (2.0 * one)) \
            / torch.sqrt(one) * weight
    return torch.special.ndtr(x) * torch.special.ndtr(y) + acc * rho / (2.0 * math.pi)


def _rectangle(lower, upper, mean, cov):
    sx = torch.sqrt(torch.clamp(cov[..., 0, 0], min=1e-12))
    sy = torch.sqrt(torch.clamp(cov[..., 1, 1], min=1e-12))
    rho = torch.clamp(cov[..., 0, 1] / (sx * sy), -0.99, 0.99)
    a1 = (lower[..., 0] - mean[..., 0]) / sx
    a2 = (lower[..., 1] - mean[..., 1]) / sy
    b1 = (upper[..., 0] - mean[..., 0]) / sx
    b2 = (upper[..., 1] - mean[..., 1]) / sy
    a1, a2, b1, b2, rho = torch.broadcast_tensors(a1, a2, b1, b2, rho)
    p = (_bvn_cdf(b1, b2, rho) - _bvn_cdf(a1, b2, rho) - _bvn_cdf(b1, a2, rho)
         + _bvn_cdf(a1, a2, rho))
    return torch.clamp(p, 0.0, 1.0)


def collision_probability(ro, preds: Preds, length: float, width: float):
    """(M, O, t) probability that ego step j+1 meets prediction step j."""
    n1 = ro["x"].shape[-1]
    t = min(n1 - 1, preds.means.shape[-2] - 1)
    mean_c = preds.means[:, :t]                                    # (O, t, 2)
    yaw = preds.orientations[:, 1:t + 1]
    half = torch.stack([torch.cos(yaw), torch.sin(yaw)], -1) * (preds.lengths[:, None, None] / 2)
    means3 = [mean_c, mean_c + half, mean_c - half]
    cov = preds.covs[:, :t]
    zero = torch.all((torch.abs(cov) < 1e-12).flatten(-2), dim=-1)
    cov = torch.where(zero[..., None, None],
                      torch.eye(2, dtype=cov.dtype, device=cov.device) * 0.1, cov)
    ego = torch.stack([ro["x"][:, 1:t + 1], ro["y"][:, 1:t + 1]], -1)     # (M, t, 2)
    th = ro["theta_gl"][:, 1:t + 1]
    heading = torch.stack([torch.cos(th), torch.sin(th)], -1)
    off = (2.0 / 3.0) * (length / 2.0)
    centers3 = [ego, ego + off * heading, ego - off * heading]
    half_box = torch.tensor([length / 6.0, width / 2.0], dtype=ego.dtype, device=ego.device)

    dist = torch.stack([torch.sqrt(torch.sum((m[None] - ego[:, None]) ** 2, -1))
                        for m in means3])
    gate = torch.amin(dist, dim=0) <= 5.0                           # (M, O, t)
    prob = None
    for c in centers3:
        for m in means3:
            p = _rectangle((c - half_box)[:, None], (c + half_box)[:, None], m[None],
                           cov[None])
            prob = p if prob is None else prob + p
    return prob / 3.0 * gate.to(prob.dtype) * preds.valid[None, :, :t].to(prob.dtype), t


def _angle_range(angle):
    wrapped = torch.remainder(angle + math.pi, 2.0 * math.pi) - math.pi
    return torch.where(wrapped == -math.pi, math.pi, wrapped)


def _log_reg_sym(dv, angle):
    a = _angle_range(angle)
    q = math.pi / 4.0
    front = (a > -q) & (a < q)
    side = ((a >= q) & (a < 3 * q)) | ((a <= -q) & (a > -3 * q))
    area = torch.where(front, 0.0, torch.where(side, LOG_REG_SYM["side"],
                                               LOG_REG_SYM["rear"])).to(dv.dtype)
    return 1.0 / (1.0 + torch.exp(-LOG_REG_SYM["const"] - LOG_REG_SYM["speed"] * dv - area))


def footprint_meta(lengths, widths):
    """(mass, protected): car-class regression above 2.5 m², else a 250 /
    90 / 75 kg unprotected road user."""
    size = lengths * widths
    protected = size >= 2.5
    car = -1333.5 + 526.9 * torch.clamp(size, min=1.0) ** 0.8
    small = torch.where(size < 0.6, 75.0, torch.where(size < 1.4, 90.0, 250.0)).to(size.dtype)
    return torch.where(protected, car, small), protected


def trajectory_risks(ro, preds: Preds, veh: Vehicle):
    """(obst_risk_per_obst (M, O), obst_present (O,))."""
    n1 = ro["x"].shape[-1]
    pl = min(n1 - 1, preds.means.shape[-2])
    th = ro["theta_gl"][:, None, :pl]
    v = ro["v"][:, None, :pl]
    x, y = ro["x"][:, None, :pl], ro["y"][:, None, :pl]
    yaw = preds.orientations[None, :, :pl]
    pv = preds.velocities[None, :, :pl]
    px, py = preds.means[None, :, :pl, 0], preds.means[None, :, :pl, 1]
    pdof = yaw - th + math.pi
    rel = torch.atan2(py - y, px - x)
    obs_angle = math.pi + rel - yaw
    dv = torch.sqrt(torch.clamp(v ** 2 + pv ** 2 + 2.0 * v * pv * torch.cos(pdof), min=0.0))
    mass, protected = footprint_meta(preds.lengths, preds.widths)
    m_o = mass[None, :, None]
    obst_dv = veh.mass / (veh.mass + m_o) * dv
    # only the obstacle's risk enters the responsibility term
    obst_harm = torch.where(protected[None, :, None], _log_reg_sym(obst_dv, obs_angle),
                            1.0 / (1.0 + torch.exp(PEDESTRIAN["const"]
                                                   - PEDESTRIAN["speed"] * obst_dv)))
    prob, pt = collision_probability(ro, preds, veh.length, veh.width)
    t = min(pl, pt)
    step_ok = preds.valid[None, :, :t].to(prob.dtype)
    present = torch.any(preds.valid, dim=-1)
    risk = torch.amax(obst_harm[..., :t] * prob[..., :t] * step_ok, dim=-1) \
        * present[None].to(prob.dtype)
    return risk, present


def responsibility(ro, grid, risk, present, dt: float):
    """(M,) −Σ_o risk_o over the obstacles whose reach set never holds the
    ego's position; `grid` = (origin (O, 2), occupancy (O, T, G, G), valid
    (O,), cell (O,), dt_rs)."""
    origin, occ, valid, cell, dt_rs = grid
    if origin.shape[0] == 0:
        return torch.zeros(risk.shape[0], dtype=risk.dtype, device=risk.device)
    n = ro["x"].shape[-1] - 1
    g, t_rs = occ.shape[-1], occ.shape[1]
    ego = torch.stack([ro["x"][:, 1:], ro["y"][:, 1:]], -1)             # (M, N, 2)
    k = torch.arange(1, n + 1, dtype=torch.float64, device=ego.device)
    step = torch.clamp(torch.round(k * dt / dt_rs).long(), 0, t_rs - 1)  # (N,)
    rel = ego[:, None] - origin[None, :, None, :]                       # (M, O, N, 2)
    ij = torch.floor(rel / cell[None, :, None, None] + g / 2.0).long()
    inb = torch.all((ij >= 0) & (ij < g), dim=-1)
    i = torch.clamp(ij[..., 0], 0, g - 1)
    j = torch.clamp(ij[..., 1], 0, g - 1)
    o_idx = torch.arange(origin.shape[0], device=ego.device)[None, :, None]
    inside = occ[o_idx, step[None, None, :], i, j] & inb & valid[None, :, None]
    resp = (~torch.any(inside, dim=-1)).to(risk.dtype) * present[None].to(risk.dtype)
    prod = resp * risk
    total = prod[:, 0]
    for o in range(1, prod.shape[1]):
        total = total + prod[:, o]
    return -total
