"""Risk charts: per-obstacle risk and harm of a candidate, the risk
dashboard, the candidate fan colored by risk and the cost composition of a
run.

The port's copy of `frenetix_tpu/risk/visualization.py`, drawn the same way
(same artists, colors, dpi and `bbox_inches`).  The TrajectoryRisks and
CycleResult fields may be tensors on any device: each chart brings the
fields it draws to the host in one copy (`utils.visualization.fetch`).
matplotlib is imported inside the functions.
"""
from __future__ import annotations

import os

import numpy as np

from frenetix_tpu_torch.utils.visualization import _draw_lanelets, _vehicle_patch, fetch

__all__ = ["plot_trajectory_risk", "risk_dashboard", "plot_harm_breakdown",
           "plot_scenario_risk", "plot_cost_composition"]


def plot_trajectory_risk(risks, preds, save_path=None, candidate=0):
    """Bar chart: per-obstacle max ego/obstacle risk of one candidate."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    ego, obst, present = fetch(risks.ego_risk_per_obst[candidate],
                               risks.obst_risk_per_obst[candidate], risks.obst_present)
    idxs = np.where(present)[0]
    fig, ax = plt.subplots(figsize=(7, 4))
    x = np.arange(len(idxs))
    ax.bar(x - 0.2, ego[idxs], width=0.4, label="ego risk", color="#4477aa")
    ax.bar(x + 0.2, obst[idxs], width=0.4, label="obstacle risk", color="#ee6677")
    ax.set_xticks(x)
    ax.set_xticklabels([f"obs {i}" for i in idxs])
    ax.set_ylabel("max risk (harm × collision probability)")
    ax.legend()
    ax.set_title(f"candidate {candidate}: per-obstacle risk")
    if save_path:
        os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
        fig.savefig(save_path, dpi=100, bbox_inches="tight")
        plt.close(fig)
        return save_path
    return fig, ax


def risk_dashboard(res, risks, save_path=None):
    """Compact dashboard: cost vs. risk scatter of all candidates, the risk
    distribution and the selection summary."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    cost, total_risk, sel, best = fetch(res.cost, risks.ego_risk + risks.obst_risk,
                                        res.selectable, res.best_idx)

    fig, axs = plt.subplots(1, 3, figsize=(15, 4.2))
    axs[0].scatter(cost[sel], total_risk[sel], s=4, c="#4477aa", label="selectable")
    axs[0].scatter(cost[~sel], total_risk[~sel], s=4, c="#cc3333", alpha=0.3,
                   label="rejected")
    axs[0].set_xlabel("weighted cost")
    axs[0].set_ylabel("ego+obstacle risk")
    axs[0].set_xlim(0, np.percentile(cost[cost < 1e14], 99) if (cost < 1e14).any() else 1)
    axs[0].legend()
    axs[0].set_title("cost vs. risk")

    axs[1].hist(total_risk[total_risk > 0], bins=40, color="#66ccee")
    axs[1].set_xlabel("trajectory risk")
    axs[1].set_title("risk distribution")

    best = int(best)
    axs[2].bar(["candidates", "selectable", "best risk ×100"],
               [len(cost), int(sel.sum()), float(total_risk[best]) * 100],
               color=["#999", "#4477aa", "#228833"])
    axs[2].set_title("selection summary")

    fig.suptitle("risk dashboard")
    if save_path:
        os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
        fig.savefig(save_path, dpi=100, bbox_inches="tight")
        plt.close(fig)
        return save_path
    return fig, axs


def plot_harm_breakdown(risks, save_path=None, candidate=0):
    """Harm vs. risk per obstacle for one candidate: harm is the injury
    probability, risk = harm × collision probability; the gap between the
    bars shows how much the collision probability discounts each obstacle."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    ego_h, obst_h, ego_r, obst_r, present = fetch(
        risks.ego_harm_per_obst[candidate], risks.obst_harm_per_obst[candidate],
        risks.ego_risk_per_obst[candidate], risks.obst_risk_per_obst[candidate],
        risks.obst_present)
    idxs = np.where(present)[0]

    fig, axs = plt.subplots(1, 2, figsize=(11, 4))
    x = np.arange(len(idxs))
    for ax, h, r, title in (
        (axs[0], ego_h, ego_r, "ego"),
        (axs[1], obst_h, obst_r, "obstacle"),
    ):
        ax.bar(x - 0.2, h[idxs], width=0.4, color="#cccccc", label="harm")
        ax.bar(x + 0.2, r[idxs], width=0.4, color="#ee6677", label="risk")
        ax.set_xticks(x)
        ax.set_xticklabels([f"obs {i}" for i in idxs])
        ax.set_title(f"{title} harm vs. risk")
        ax.legend()
    fig.suptitle(f"candidate {candidate}: harm breakdown")
    if save_path:
        os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
        fig.savefig(save_path, dpi=100, bbox_inches="tight")
        plt.close(fig)
        return save_path
    return fig, axs


def plot_scenario_risk(scenario, agents, res, risks, t, save_path=None,
                       window=60.0):
    """Candidate fan over the map colored by RISK instead of cost
    (harm × probability, green → red)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.cm as cm
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(11, 9))
    _draw_lanelets(ax, scenario)
    total, ok, x, y, best = fetch(risks.ego_risk + risks.obst_risk, res.selectable,
                                  res.rollout.x, res.rollout.y, res.best_idx)
    rmax = max(float(total[ok].max()) if ok.any() else 1.0, 1e-9)
    for i in range(len(x)):
        if not ok[i]:
            continue
        ax.plot(x[i], y[i], color=cm.RdYlGn_r(total[i] / rmax), lw=0.4,
                alpha=0.6, zorder=4)
    best = int(best)
    ax.plot(x[best], y[best], color="#0044cc", lw=2.0, zorder=12)
    for a in agents:
        _vehicle_patch(ax, a.state.position, a.state.orientation, 4.508,
                       1.61, "#228833", zorder=11)
        c = a.state.position
        ax.set_xlim(c[0] - window, c[0] + window)
        ax.set_ylim(c[1] - window * 0.75, c[1] + window * 0.75)
    sm = plt.cm.ScalarMappable(cmap=cm.RdYlGn_r,
                               norm=plt.Normalize(0.0, rmax))
    fig.colorbar(sm, ax=ax, shrink=0.7, label="total risk")
    ax.set_aspect("equal")
    ax.set_title(f"{scenario.scenario_id} — candidate risk, t = {t}")
    if save_path:
        os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
        fig.savefig(save_path, dpi=100, bbox_inches="tight")
        plt.close(fig)
        return save_path
    return fig, ax


def plot_cost_composition(logs_csv_path, save_path=None):
    """Stacked per-term cost composition of the selected trajectory over the
    run, from an agent's logs.csv."""
    import csv

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    with open(logs_csv_path) as f:
        rows = list(csv.DictReader(f, delimiter=";"))
    if not rows:
        raise ValueError(f"no cycles logged in {logs_csv_path}")
    terms = [k for k in rows[0]
             if k.startswith("costs_") and not k.startswith("costs_unweighted_")]
    t = np.array([int(r["trajectory_number"]) for r in rows])
    series = {k: np.array([float(r[k] or 0.0) for r in rows]) for k in terms}

    fig, (ax1, ax2) = plt.subplots(2, 1, figsize=(9, 7), sharex=True)
    ax1.stackplot(t, *(np.maximum(series[k], 0.0) for k in terms),
                  labels=[k.removeprefix("costs_") for k in terms], alpha=0.8)
    ax1.set_ylabel("weighted cost (stacked)")
    ax1.legend(fontsize=7, ncol=2)
    total = np.array([float(r["optimal_trajectory_cost"]) for r in rows])
    ax2.plot(t, total, color="#333333")
    ax2.set_ylabel("total cost")
    ax2.set_xlabel("time step")
    fig.suptitle("selected-trajectory cost composition")
    if save_path:
        os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
        fig.savefig(save_path, dpi=100, bbox_inches="tight")
        plt.close(fig)
        return save_path
    return fig, (ax1, ax2)
