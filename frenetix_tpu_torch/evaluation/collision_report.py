"""Post-collision analysis report.

The port's own copy of `frenetix_tpu/evaluation/collision_report.py` over
the port's torch harm functions (`risk/harm.py`): identify the collision
partner, estimate the harm of both parties at the impact state
(momentum-exchange Δv and the logistic-regression / pedestrian harm models)
and write the report as JSON.  The crash plot is drawn where matplotlib
imports; without it one warning names the missing package and the JSON
report is written all the same.
"""
from __future__ import annotations

import json
import logging
import os

import numpy as np
import torch

from frenetix_tpu_torch.risk.harm import (
    log_reg_harm, obstacle_mass, obstacle_protection, pedestrian_harm,
)

__all__ = ["collision_report"]

_log = logging.getLogger(__name__)


def _harm(fn, *args) -> float:
    """A harm model on float64 scalars, on the CPU."""
    return float(fn(*(torch.tensor(float(a), dtype=torch.float64) for a in args)))


def collision_report(agent, scenario, veh, log_dir=None, other_agents=None):
    """Analyze the collision that ended `agent`; returns the report dict."""
    st = agent.state
    t = st.time_step
    partner = None
    partner_state = None
    best_d = np.inf
    candidates = list(scenario.obstacles.values())
    for ob in candidates:
        if ob.obstacle_id == agent.id:
            continue
        obs_st = ob.state_at_time(t)
        if obs_st is None:
            continue
        d = float(np.linalg.norm(np.asarray(obs_st.position) - st.position))
        if d < best_d:
            best_d, partner, partner_state = d, ob, obs_st

    report = {
        "agent_id": agent.id,
        "time_step": int(t),
        "ego_velocity": float(st.velocity),
        "ego_position": [float(v) for v in st.position],
    }
    if partner is not None and best_d < (veh.length + partner.length):
        # crash kinematics (simplified impact angles)
        pdof = partner_state.orientation - st.orientation + np.pi
        rel = np.arctan2(partner_state.position[1] - st.position[1],
                         partner_state.position[0] - st.position[0])
        ego_angle = rel - st.orientation
        obs_angle = np.pi + rel - partner_state.orientation
        delta_v = np.sqrt(max(
            st.velocity**2 + partner_state.velocity**2
            + 2 * st.velocity * partner_state.velocity * np.cos(pdof), 0.0,
        ))
        m_obs = obstacle_mass(partner.obstacle_type, partner.length * partner.width)
        m_obs = max(m_obs, 1.0)
        ego_dv = m_obs / (veh.mass + m_obs) * delta_v
        obs_dv = veh.mass / (veh.mass + m_obs) * delta_v
        prot = obstacle_protection(partner.obstacle_type)
        ego_harm = _harm(log_reg_harm, ego_dv, ego_angle)
        if prot == 1:
            obs_harm = _harm(log_reg_harm, obs_dv, obs_angle)
        elif prot == 0:
            obs_harm = _harm(pedestrian_harm, obs_dv)
        else:
            obs_harm = 1.0
        report.update({
            "partner_id": partner.obstacle_id,
            "partner_type": partner.obstacle_type,
            "partner_velocity": float(partner_state.velocity),
            "distance": best_d,
            "pdof_rad": float(pdof),
            "delta_v_ego": float(ego_dv),
            "delta_v_partner": float(obs_dv),
            "ego_harm": ego_harm,
            "partner_harm": obs_harm,
        })
    else:
        report["partner_id"] = None
        report["note"] = "no collision partner identified (road boundary?)"

    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
        with open(os.path.join(log_dir, f"collision_report_agent_{agent.id}.json"), "w") as f:
            json.dump(report, f, indent=2)
        try:
            import matplotlib
        except ImportError as e:
            _log.warning("collision plot of agent %s not drawn: %s (the JSON "
                         "report is written)", agent.id, e)
        else:
            matplotlib.use("Agg")
            _plot_crash(agent, scenario, partner, t, veh,
                        os.path.join(log_dir, f"collision_agent_{agent.id}.png"))
    return report


def _vehicle_patch(ax, pos, theta, length, width, color, zorder=10):
    from matplotlib.patches import Rectangle
    from matplotlib.transforms import Affine2D

    rect = Rectangle(
        (-length / 2, -width / 2), length, width,
        facecolor=color, edgecolor="black", lw=0.5, zorder=zorder,
    )
    rect.set_transform(
        Affine2D().rotate(theta).translate(pos[0], pos[1]) + ax.transData
    )
    ax.add_patch(rect)


def _plot_crash(agent, scenario, partner, t, veh, path):
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 7))
    for ll in scenario.lanelets.values():
        ax.fill(*ll.polygon.T, facecolor="#e8e8e8", edgecolor="none", zorder=0)
    for ll in scenario.lanelets.values():
        ax.plot(*ll.left_vertices.T, color="#555", lw=0.6, zorder=1)
        ax.plot(*ll.right_vertices.T, color="#555", lw=0.6, zorder=1)
    hist = np.array([s.position for s in agent.record.states])
    ax.plot(hist[:, 0], hist[:, 1], "b.-", ms=2)
    _vehicle_patch(ax, agent.state.position, agent.state.orientation,
                   veh.length, veh.width, "#cc3333")
    if partner is not None:
        st = partner.state_at_time(t)
        if st is not None:
            _vehicle_patch(ax, st.position, st.orientation, partner.length,
                           partner.width, "#4477aa")
    ax.set_xlim(agent.state.position[0] - 30, agent.state.position[0] + 30)
    ax.set_ylim(agent.state.position[1] - 25, agent.state.position[1] + 25)
    ax.set_aspect("equal")
    ax.set_title(f"collision — agent {agent.id} @ t={t}")
    fig.savefig(path, dpi=100, bbox_inches="tight")
    plt.close(fig)
