"""Per-candidate risks: harm × collision probability, batched.

PyTorch port of `frenetix_tpu/risk/costs.py::trajectory_risks` (with
`_harm_tensors` and `TrajectoryRisks`), the simplified crash-angle path:

  per (candidate, obstacle, timestep):
    pdof  = pred_yaw - θ_ego + π
    rel   = atan2(pred_y - y, pred_x - x)
    angles: ego = rel - θ_ego,  obstacle = π + rel - pred_yaw
    Δv    = √(v² + v_pred² + 2·v·v_pred·cos(pdof))   (momentum exchange)
    harms = model(Δv·m_other/(m_ego+m_other), angle)
    risk  = harm · collision_probability;  max over time, then obstacles.

The ethical aggregations (`bayesian_costs`, `equality_costs`,
`maximin_costs`, `ego_costs`, `responsibility_costs`) follow; like the JAX
module's they have no caller in the package.  Everything takes leading agent
axes; sums over obstacles add the slots one by one (`sum_obstacles`).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from frenetix_tpu_torch.ops.kinematics import VehicleParams
from frenetix_tpu_torch.risk import harm as harm_mod
from frenetix_tpu_torch.risk.probability import (
    collision_probability_fast, inv_mahalanobis,
)

__all__ = [
    "DEFAULT_RISK_MODES", "TrajectoryRisks", "trajectory_risks", "sum_obstacles",
    "bayesian_costs", "equality_costs", "maximin_costs", "ego_costs",
    "responsibility_costs",
]

DEFAULT_RISK_MODES = {
    "harm_mode": "log_reg",
    "ignore_angle": False,
    "sym_angle": True,
    "reduced_angle_areas": True,
    "crash_angle_simplified": True,
    "fast_prob_mahalanobis": False,
    "trajectory_risk": "max",
    "max_acceptable_risk": 1.0,
}


class TrajectoryRisks(NamedTuple):
    ego_risk_per_obst: torch.Tensor   # (..., M, O) max-over-time ego risk
    obst_risk_per_obst: torch.Tensor  # (..., M, O)
    ego_harm_per_obst: torch.Tensor   # (..., M, O) max-over-time harm
    obst_harm_per_obst: torch.Tensor  # (..., M, O)
    ego_risk: torch.Tensor            # (..., M) max over obstacles
    obst_risk: torch.Tensor           # (..., M)
    obst_present: torch.Tensor        # (..., O) bool
    coll_prob_per_obst: Optional[torch.Tensor] = None  # (..., M, O) max-over-time


def _harm_tensors(ro, preds, meta, ego_mass, coeffs, modes, pl):
    """(ego_harm, obst_harm) of shape (..., M, O, pl): impact angles by the
    simplified crash-angle model, the mass-ratio Δv split, then the
    protected / unprotected / structure model selection."""
    theta = ro.theta_gl[..., :, None, :pl]          # (..., M, 1, t)
    v_ego = ro.v[..., :, None, :pl]
    x = ro.x[..., :, None, :pl]
    y = ro.y[..., :, None, :pl]
    pred_yaw = preds.orientations[..., None, :, :pl]  # (..., 1, O, t)
    pred_v = preds.velocities[..., None, :, :pl]
    px = preds.means[..., None, :, :pl, 0]
    py = preds.means[..., None, :, :pl, 1]

    pdof = pred_yaw - theta + math.pi
    rel = torch.atan2(py - y, px - x)
    ego_angle = rel - theta
    obs_angle = math.pi + rel - pred_yaw

    delta_v = torch.sqrt(
        torch.clamp(
            v_ego**2 + pred_v**2 + 2.0 * v_ego * pred_v * torch.cos(pdof), min=0.0
        )
    )
    m_obst = meta.mass[..., None, :, None]
    ego_dv = m_obst / (ego_mass + m_obst) * delta_v
    obst_dv = ego_mass / (ego_mass + m_obst) * delta_v

    kw = dict(
        coeffs=coeffs,
        ignore_angle=modes["ignore_angle"],
        sym=modes["sym_angle"],
        reduced=modes["reduced_angle_areas"],
    )
    if modes["harm_mode"] == "log_reg":
        harm_prot_ego = harm_mod.log_reg_harm(ego_dv, ego_angle, **kw)
        harm_prot_obs = harm_mod.log_reg_harm(obst_dv, obs_angle, **kw)
    elif modes["harm_mode"] == "ref_speed":
        harm_prot_ego = harm_mod.ref_speed_harm(ego_dv, ego_angle, **kw)
        harm_prot_obs = harm_mod.ref_speed_harm(obst_dv, obs_angle, **kw)
    else:  # gidas
        harm_prot_ego = harm_mod.gidas_harm(ego_dv, coeffs)
        harm_prot_obs = harm_mod.gidas_harm(obst_dv, coeffs)

    # unprotected opponents: ego harm by the ignore-angle log-reg, obstacle
    # harm by the pedestrian regression; static structures → harm 1
    harm_unprot_ego = harm_mod.log_reg_harm(ego_dv, ego_angle, coeffs=coeffs,
                                            ignore_angle=True)
    harm_unprot_obs = harm_mod.pedestrian_harm(obst_dv, coeffs)

    prot = meta.protected[..., None, :, None]
    ego_harm = torch.where(prot == 1, harm_prot_ego,
                           torch.where(prot == 0, harm_unprot_ego, 1.0))
    obst_harm = torch.where(prot == 1, harm_prot_obs,
                            torch.where(prot == 0, harm_unprot_obs, 1.0))
    return ego_harm, obst_harm


def trajectory_risks(
    ro,
    preds,
    meta: harm_mod.ObstacleMeta,
    ego_mass: float,
    coeffs=None,
    modes=None,
) -> TrajectoryRisks:
    """Risks of all M candidates of a rollout against the O predicted
    obstacles, on the rollout's device.  A rollout (..., M, N+1) with
    predictions (..., O, T) and metadata (..., O) gives risks with the same
    leading agent axes; every reduction runs over a trailing axis, so an
    agent's slice equals its risks alone."""
    coeffs = coeffs or harm_mod.DEFAULT_HARM_COEFFS
    modes = modes or DEFAULT_RISK_MODES
    rows = tuple(ro.x.shape[:-1])             # (..., M)
    o = preds.num_obstacles
    dtype, device = ro.x.dtype, ro.x.device
    if o == 0:
        z2 = torch.zeros(rows + (0,), dtype=dtype, device=device)
        z1 = torch.zeros(rows, dtype=dtype, device=device)
        return TrajectoryRisks(z2, z2, z2, z2, z1, z1,
                               torch.zeros(rows[:-1] + (0,), dtype=torch.bool,
                                           device=device), z2)

    n1 = ro.x.shape[-1]
    # harm alignment: ego step i against prediction step i, i = 0..pl-1
    pl = min(n1 - 1, preds.horizon)
    ego_harm, obst_harm = _harm_tensors(ro, preds, meta, ego_mass, coeffs,
                                        modes, pl)

    # collision probability: output index j pairs ego step j+1 with
    # prediction step j; harm[t]·prob[t] are multiplied index by index
    if modes["fast_prob_mahalanobis"]:
        prob, pt = inv_mahalanobis(ro, preds)
    else:
        # only length and width are used, for the 3-rectangle shape
        prob, pt = collision_probability_fast(ro, preds, VehicleParams())
    t = min(pl, pt)
    step_ok = preds.valid[..., None, :, :t].to(dtype)
    ego_risk_t = ego_harm[..., :t] * prob[..., :t] * step_ok
    obst_risk_t = obst_harm[..., :t] * prob[..., :t] * step_ok

    obst_present = torch.any(preds.valid, dim=-1)
    pm = obst_present[..., None, :].to(dtype)
    ego_risk_po = torch.amax(ego_risk_t, dim=-1) * pm
    obst_risk_po = torch.amax(obst_risk_t, dim=-1) * pm
    ego_harm_po = torch.amax(ego_harm[..., :t] * step_ok, dim=-1) * pm
    obst_harm_po = torch.amax(obst_harm[..., :t] * step_ok, dim=-1) * pm

    return TrajectoryRisks(
        ego_risk_per_obst=ego_risk_po,
        obst_risk_per_obst=obst_risk_po,
        ego_harm_per_obst=ego_harm_po,
        obst_harm_per_obst=obst_harm_po,
        ego_risk=torch.amax(ego_risk_po, dim=-1),
        obst_risk=torch.amax(obst_risk_po, dim=-1),
        obst_present=obst_present,
        coll_prob_per_obst=torch.amax(prob[..., :t] * step_ok, dim=-1) * pm,
    )


def sum_obstacles(per_obst):
    """Σ over the trailing obstacle axis, the O terms added one by one in
    slot order: no library reduction, whose order may change with the batch
    shape, so a batched sum equals the sequential one bit for bit."""
    total = per_obst[..., 0]
    for k in range(1, per_obst.shape[-1]):
        total = total + per_obst[..., k]
    return total


def _n_present(risks):
    """Number of present obstacles, at least 1; (..., 1) to divide (..., M)."""
    n = torch.sum(risks.obst_present, dim=-1, keepdim=True)
    return torch.clamp(n, min=1)


def bayesian_costs(risks: TrajectoryRisks, boundary_harm):
    """(Σ ego_risk + Σ obst_risk + boundary_harm) / (2·n)."""
    n = _n_present(risks)
    return (
        sum_obstacles(risks.ego_risk_per_obst)
        + sum_obstacles(risks.obst_risk_per_obst)
        + boundary_harm
    ) / (2.0 * n)


def equality_costs(risks: TrajectoryRisks):
    """Σ |ego_risk_o - obst_risk_o| / n."""
    n = _n_present(risks)
    return sum_obstacles(
        torch.abs(risks.ego_risk_per_obst - risks.obst_risk_per_obst)) / n


def maximin_costs(risks: TrajectoryRisks, boundary_harm, eps=1e-9, scale=10):
    """Max harm among near-zero-risk partners, to the power `scale`."""
    dtype = risks.ego_harm_per_obst.dtype
    mm_ego = risks.ego_harm_per_obst * (risks.ego_risk_per_obst < eps).to(dtype)
    mm_obst = risks.obst_harm_per_obst * (risks.obst_risk_per_obst < eps).to(dtype)
    m = torch.maximum(torch.amax(mm_ego, dim=-1), torch.amax(mm_obst, dim=-1))
    return torch.maximum(m, torch.as_tensor(boundary_harm, dtype=dtype,
                                            device=m.device)) ** scale


def ego_costs(risks: TrajectoryRisks, boundary_harm):
    """Σ ego_risk + boundary_harm."""
    return sum_obstacles(risks.ego_risk_per_obst) + boundary_harm


def responsibility_costs(risks: TrajectoryRisks, preds, ego_position, ego_orientation):
    """Action-space responsibility: obstacles outside the ego's forward ±45°
    sector carry their own risk: cost = -Σ resp_o · obst_risk_o.
    `ego_position` (..., 2) and `ego_orientation` (...) are tensors or
    numbers."""
    dtype = risks.obst_risk_per_obst.dtype
    pos = torch.as_tensor(ego_position, dtype=dtype, device=preds.means.device)
    th = torch.as_tensor(ego_orientation, dtype=dtype, device=preds.means.device)
    rel = torch.atan2(
        preds.means[..., :, 0, 1] - pos[..., 1, None],
        preds.means[..., :, 0, 0] - pos[..., 0, None],
    )
    inside = torch.abs(
        torch.remainder(rel - th[..., None] + math.pi, 2 * math.pi) - math.pi
    ) <= (math.pi / 4.0)
    # the constants in the cost's dtype: a where() of two Python numbers
    # would come out in float32
    resp = (~inside).to(dtype) * risks.obst_present.to(dtype)
    return -sum_obstacles(resp[..., None, :] * risks.obst_risk_per_obst)
