"""The plain reference: what the planner should answer to one request.

`solve` works out everything from the raw request again (reference tables,
corridor, sampling matrices, rollouts, costs, checks, the selection, and
with a responsibility weight the risk stack and the re-selection), one
agent at a time, in the dtype it is given: float64 to judge the program,
lower for the control.  It imports neither the program nor JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench import generate
from portbench.reference import cycle, risk, road


def _tables(line, config, dtype, device) -> cycle.Tables:
    tab = road.reference_path(line, extension=config["road"]["extension_m"])
    corr = road.strip_corridor(len(tab.s), config["road"]["corridor_half_width_m"])
    cols = np.column_stack([tab.theta, tab.kappa, tab.kappa_d, tab.xy, corr])
    return cycle.Tables(s=torch.as_tensor(tab.s, dtype=dtype, device=device),
                        cols=torch.as_tensor(cols, dtype=dtype, device=device))


def sampling(config, req, a):
    """(padded (M, 13) matrix, mask) of agent `a` in float64."""
    x0_lon, x0_lat = tuple(req["x0_lon"][a]), tuple(req["x0_lat"][a])
    t1, ss1, d1 = generate.sampling_ranges(config, x0_lon, x0_lat)
    return road.pad_rows(road.sampling_matrix(t1, ss1, d1, x0_lon, x0_lat),
                         config["sampling"]["bucket"])


def solve(config, lines, req, *, dtype=torch.float64, device="cpu"):
    """Per agent (lists over A): `cost` (M,) of the selection (with the
    responsibility term where weighted), `selectable` (M,), `best`, `found`,
    `hist` (11,) over the real rows, `rows` (12, M, N+1) in the program's
    order [x, y, θ, v, a, κ, s, ṡ, s̈, d, ḋ, d̈], `resp` (M,) the weighted
    responsibility term inside `cost` (zeros without one), `mask` (M,) the
    real rows, and `n_valid`."""
    veh = cycle.Vehicle(**config["vehicle"])
    p = config["planning"]
    n_steps = generate.planning_steps(config)
    weights = config["cost_weights"]
    w_resp = config.get("responsibility", 0.0)
    out = {k: [] for k in ("cost", "selectable", "best", "found", "hist", "rows",
                           "resp", "mask", "n_valid")}

    def t(x, dt=dtype):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dt, device=device)

    for a in range(config["agents"]):
        matrix, mask = sampling(config, req, a)
        mask_t = torch.as_tensor(mask, device=device)
        tab = _tables(lines[a], config, dtype, device)
        preds = cycle.Preds(
            means=t(req["means"][a]), inv_covs=t(req["inv_covs"][a]),
            covs=t(req["covs"][a]), orientations=t(req["orientations"][a]),
            velocities=t(req["velocities"][a]), lengths=t(req["lengths"][a]),
            widths=t(req["widths"][a]), valid=t(req["valid"][a], torch.bool))
        ro = cycle.rollout(t(matrix), tab, veh, float(req["x0_orientation"][a]),
                           dt=p["dt"], n_steps=n_steps, window=config["table_window"])
        cost = cycle.cost_terms(ro, preds, dt=p["dt"],
                                desired_velocity=float(req["desired_velocity"][a]),
                                weights=weights)
        selectable = (ro["feasible"] & ro["valid"] & ~cycle.collides(ro, preds, veh)
                      & ~cycle.off_road(ro, veh) & mask_t)
        resp = torch.zeros_like(cost)
        if w_resp:
            obst_risk, present = risk.trajectory_risks(ro, preds, veh)
            grid = (t(req["grid_origin"][a]), t(req["grid_occupancy"][a], torch.bool),
                    t(req["grid_valid"][a], torch.bool), t(req["grid_cell"][a]),
                    float(config["reach_grid_dt_s"]))
            resp = w_resp * risk.responsibility(ro, grid, obst_risk, present, p["dt"])
            cost = cost + resp
        best, found = cycle.select(cost, selectable)
        hist = torch.sum(ro["slots"] & mask_t[:, None], dim=0)
        rows = torch.stack([ro[k] for k in ("x", "y", "theta_gl", "v", "a", "kappa", "s",
                                            "s_vel", "s_acc", "d", "d_vel", "d_acc")])
        for k, v in (("cost", cost), ("selectable", selectable), ("best", int(best)),
                     ("found", bool(found)), ("hist", hist), ("rows", rows),
                     ("resp", resp), ("mask", mask), ("n_valid", int(mask.sum()))):
            out[k].append(v)
    return out
