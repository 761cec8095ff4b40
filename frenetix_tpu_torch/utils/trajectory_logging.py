"""Per-agent planner logging: trajectories.db (SQLite) + logs.csv.

The port's own copy of `frenetix_tpu/utils/trajectory_logging.py`, with the
same tables and columns:
  - trajectories.db tables `trajectories`, `trajectories_meta`,
    `sampling_params`, `meta`, `costs`, `infeasability` and
    `reference_path`;
  - logs.csv with the selected trajectory of every cycle: its cost per term,
    the 11 infeasibility counters and the planning time.

The writer takes host NumPy arrays: the selected trajectory (default) or,
with `save_all_traj`, every candidate of the cycle's `CycleResult`, whose
torch tensors come to the host in one copy.
"""
from __future__ import annotations

import json
import os
import sqlite3

import numpy as np
import torch

from frenetix_tpu_torch.ops.costs import COST_TERM_ORDER
from frenetix_tpu_torch.utils.sim_logging import require_strict_tables

__all__ = ["TrajectoryLogger"]

INF_NAMES = [
    "Yaw_rate", "Acceleration", "Curvature", "Curvature_rate",
]

# rollout fields of every candidate row, in the order of the host copy
_CANDIDATE_FIELDS = ("x", "y", "theta_gl", "theta_cl", "kappa_gl", "v", "a",
                     "s", "d")


def _float_values(values) -> str:
    return "[" + ",".join("{:.5g}".format(float(x)) for x in values) + "]"


def _candidates_to_host(res, m: int) -> dict:
    """The first `m` candidates' fields of a CycleResult as host arrays, in
    ONE device→host copy: every field is cut to its first m rows, cast to
    the rollout's float type (the feasibility flags survive exactly) and
    concatenated per row."""
    ro = res.rollout
    named = {k: getattr(ro, k) for k in _CANDIDATE_FIELDS}
    named.update(cost=res.cost, terms=res.cost_terms, feasible=ro.feasible,
                 slots=ro.inf_slots)
    dtype = ro.x.dtype
    parts = [t[:m].to(dtype).reshape(m, -1) for t in named.values()]
    flat = torch.cat(parts, dim=1).cpu().numpy()
    host, col = {}, 0
    for (k, t), p in zip(named.items(), parts):
        w = p.shape[1]
        host[k] = flat[:, col] if t.dim() == 1 else flat[:, col:col + w]
        col += w
    return host


class TrajectoryLogger:
    def __init__(self, log_dir: str, cost_names, config_dict=None,
                 save_all_traj: bool = False, save_unweighted: bool = False,
                 log_risk: bool = False):
        require_strict_tables()
        os.makedirs(log_dir, exist_ok=True)
        self.log_dir = log_dir
        self.cost_names = list(cost_names)
        self.save_all_traj = save_all_traj
        self.save_unweighted = save_unweighted
        self.log_risk = log_risk

        # save_all_traj also writes trajectories.csv (semicolon-separated,
        # one row per candidate per cycle) next to the SQLite tables
        self._traj_csv = None
        if save_all_traj:
            self._traj_csv = os.path.join(log_dir, "trajectories.csv")
            header = (
                "time_step;trajectory_number;unique_id;feasible;horizon;dt;"
                "x_positions_m;y_positions_m;theta_orientations_rad;"
                "kappa_rad;curvilinear_orientations_rad;velocities_mps;"
                "accelerations_mps2;s_position_m;d_position_m;ego_risk;"
                "obst_risk;costs_cumulative_weighted;"
                + ";".join(self.cost_names) + ";"
                "inf_kin_yaw_rate;inf_kin_acceleration;"
                "inf_kin_max_curvature;inf_kin_max_curvature_rate"
            )
            with open(self._traj_csv, "w") as fh:
                fh.write(header + "\n")

        self.con = sqlite3.connect(os.path.join(log_dir, "trajectories.db"))
        c = self.con
        c.execute(
            """CREATE TABLE IF NOT EXISTS trajectories(
                time_step INT NOT NULL, id INT NOT NULL,
                x TEXT NOT NULL, y TEXT NOT NULL, theta TEXT NOT NULL,
                kappa TEXT NOT NULL, curvilinear_theta TEXT NOT NULL,
                v TEXT NOT NULL, a TEXT NOT NULL,
                trajectory_long TEXT NOT NULL, trajectory_lat TEXT NOT NULL,
                PRIMARY KEY(time_step, id)) STRICT"""
        )
        c.execute(
            """CREATE TABLE IF NOT EXISTS trajectories_meta(
                time_step INT NOT NULL, id INT NOT NULL, dt REAL NOT NULL,
                s_position REAL NOT NULL, d_position REAL NOT NULL,
                ego_risk REAL, obst_risk REAL, collision_detected INT,
                boundary_harm REAL, horizon REAL NOT NULL,
                PRIMARY KEY(time_step, id)) STRICT"""
        )
        c.execute(
            """CREATE TABLE IF NOT EXISTS sampling_params(
                time_step INT NOT NULL, id INT NOT NULL,
                t0 REAL NOT NULL, t1 REAL NOT NULL, s0 REAL NOT NULL,
                ss0 REAL NOT NULL, sss0 REAL NOT NULL, ss1 REAL NOT NULL,
                sss1 REAL NOT NULL, d0 REAL NOT NULL, dd0 REAL NOT NULL,
                ddd0 REAL NOT NULL, d1 REAL NOT NULL, dd1 REAL NOT NULL,
                ddd1 REAL NOT NULL, PRIMARY KEY(time_step, id)) STRICT"""
        )
        c.execute("CREATE TABLE IF NOT EXISTS meta(key TEXT PRIMARY KEY, value ANY) STRICT")
        cost_columns = ", ".join(f"{n} REAL NOT NULL" for n in self.cost_names)
        c.execute(
            f"""CREATE TABLE IF NOT EXISTS costs(
                time_step INT NOT NULL, id INT NOT NULL,
                costs_cumulative_weighted REAL NOT NULL, {cost_columns},
                PRIMARY KEY(time_step, id)) STRICT"""
        )
        inf_columns = ", ".join(f"{n} REAL NOT NULL" for n in INF_NAMES)
        c.execute(
            f"""CREATE TABLE IF NOT EXISTS infeasability(
                time_step INT NOT NULL, id INT NOT NULL, feasible INT NOT NULL,
                {inf_columns}, PRIMARY KEY(time_step, id)) STRICT"""
        )
        c.execute(
            """CREATE TABLE IF NOT EXISTS reference_path(
                idx INT PRIMARY KEY, x REAL NOT NULL, y REAL NOT NULL) STRICT"""
        )
        if config_dict is not None:
            c.execute(
                "INSERT OR REPLACE INTO meta VALUES(?, json(?))",
                ("config_plan", json.dumps(config_dict, default=str)),
            )
        c.commit()

        self.csv_path = os.path.join(log_dir, "logs.csv")
        header = (
            ["trajectory_number", "calculation_time_s", "x_position_vehicle_m",
             "y_position_vehicle_m", "optimal_trajectory_cost", "infeasible_kinematics_sum",
             "inf_kin_acceleration", "inf_kin_negative_s_velocity", "inf_kin_max_s_idx",
             "inf_kin_negative_v_velocity", "inf_kin_max_curvature",
             "inf_kin_yaw_rate", "inf_kin_max_curvature_rate", "inf_kin_vehicle_acc",
             "inf_cartesian_transform", "inf_precision_error",
             "velocities_mps", "accelerations_mps2", "s_position_m", "d_position_m",
             "desired_velocity_mps", "trajectory_mode"]
            + [f"costs_{n}" for n in self.cost_names]
            # debug.save_unweighted_costs: raw (pre-weight) term columns
            + ([f"costs_unweighted_{n}" for n in self.cost_names]
               if save_unweighted else [])
            # debug.log_risk: the selected plan's risks
            + (["ego_risk", "obst_risk"] if log_risk else [])
        )
        with open(self.csv_path, "w") as f:
            f.write(";".join(header) + "\n")

    def write_reference_path(self, xy: np.ndarray):
        rows = [(i, float(p[0]), float(p[1])) for i, p in enumerate(xy)]
        self.con.execute("DELETE FROM reference_path")
        self.con.executemany("INSERT INTO reference_path VALUES(?, ?, ?)", rows)
        self.con.commit()

    # ------------------------------------------------------------- per cycle
    def log_cycle(self, time_step: int, plan, histogram, planning_time: float,
                  desired_velocity: float, cost_weights=None):
        """One row per replanning cycle for the selected trajectory."""
        hist = list(np.asarray(histogram, dtype=int))
        hist = (hist + [0] * 11)[:11]
        order = {n: i for i, n in enumerate(COST_TERM_ORDER)}
        terms = []
        if plan.cost_terms is not None and cost_weights is not None:
            for n in self.cost_names:
                idx = order.get(n)
                w = cost_weights.get(n, 0.0) if cost_weights else 0.0
                terms.append(float(plan.cost_terms[idx]) * w if idx is not None else 0.0)
        else:
            terms = [0.0] * len(self.cost_names)
        row = (
            [time_step, round(planning_time, 5), _float_values(plan.x),
             _float_values(plan.y), round(plan.cost, 5), hist[0],
             *hist[1:11],
             _float_values(plan.v), _float_values(plan.a),
             _float_values(plan.s), _float_values(plan.d),
             round(float(desired_velocity), 3), plan.mode]
            + [round(t, 6) for t in terms]
        )
        if self.save_unweighted:
            if plan.cost_terms is not None:
                row += [round(float(plan.cost_terms[order[n]]), 6)
                        if n in order else 0.0 for n in self.cost_names]
            else:
                row += [0.0] * len(self.cost_names)
        if self.log_risk:
            # empty fields (not the string 'None') when a cycle carries no
            # risk: standstill plans, phases without obstacles
            row += ["" if v is None else v
                    for v in (getattr(plan, "ego_risk", None),
                              getattr(plan, "obst_risk", None))]
        with open(self.csv_path, "a") as f:
            f.write(";".join(str(v) for v in row) + "\n")

        self._log_selected_sql(time_step, plan)

    def _log_selected_sql(self, time_step: int, plan, traj_id: int = 0):
        self.con.execute(
            "INSERT OR REPLACE INTO trajectories VALUES(?,?,json(?),json(?),json(?),json(?),json(?),json(?),json(?),json(?),json(?))",
            (time_step, traj_id, _float_values(plan.x), _float_values(plan.y),
             _float_values(plan.theta), _float_values(plan.kappa),
             _float_values(np.zeros_like(plan.theta)), _float_values(plan.v),
             _float_values(plan.a), _float_values(plan.s), _float_values(plan.d)),
        )
        sp = [float(v) for v in plan.sampling_parameters]
        self.con.execute(
            f"INSERT OR REPLACE INTO sampling_params VALUES(?,?,{','.join('?' * 13)})",
            [time_step, traj_id] + sp,
        )
        self.con.execute(
            "INSERT OR REPLACE INTO trajectories_meta VALUES(?,?,?,?,?,?,?,?,?,?)",
            (time_step, traj_id, 0.1, float(plan.s[0]), float(plan.d[0]),
             getattr(plan, "ego_risk", None), getattr(plan, "obst_risk", None),
             None, None, sp[1]),
        )
        if plan.cost_terms is not None:
            order = {n: i for i, n in enumerate(COST_TERM_ORDER)}
            self.con.execute(
                f"INSERT OR REPLACE INTO costs VALUES(?,?,?,{','.join('?' * len(self.cost_names))})",
                [time_step, traj_id, float(plan.cost)]
                + [float(plan.cost_terms[order[n]]) if n in order else 0.0
                   for n in self.cost_names],
            )
        self.con.commit()

    def log_all_candidates(self, time_step: int, res, matrix, mask,
                           dt: float = 0.1):
        """save_all_traj: every candidate's geometry, costs and feasibility,
        plus the rows of trajectories.csv.  `res` is the cycle's CycleResult
        (torch tensors on any device), `matrix` and `mask` its host sampling
        matrix and padding mask."""
        m = int(np.asarray(mask).sum())
        h = _candidates_to_host(res, m)
        x, y, th, th_cl, kap = h["x"], h["y"], h["theta_gl"], h["theta_cl"], h["kappa_gl"]
        v, a, s, d = h["v"], h["a"], h["s"], h["d"]
        cost, terms, feas, slots = h["cost"], h["terms"], h["feasible"], h["slots"]
        mat = np.asarray(matrix)

        t_rows, c_rows, i_rows, sp_rows = [], [], [], []
        order = {n: i for i, n in enumerate(COST_TERM_ORDER)}
        for i in range(m):
            t_rows.append(
                (time_step, i, _float_values(x[i]), _float_values(y[i]),
                 _float_values(th[i]), _float_values(kap[i]),
                 _float_values(th_cl[i]), _float_values(v[i]),
                 _float_values(a[i]), _float_values(s[i]), _float_values(d[i]))
            )
            c_rows.append([time_step, i, float(cost[i])]
                          + [float(terms[i, order[n]]) if n in order else 0.0
                             for n in self.cost_names])
            # INF_NAMES order: yaw rate (6), acceleration (8), curvature (5),
            # curvature rate (7)
            i_rows.append([time_step, i, int(feas[i]), float(slots[i, 6]),
                           float(slots[i, 8]), float(slots[i, 5]), float(slots[i, 7])])
            sp_rows.append([time_step, i] + [float(vv) for vv in mat[i]])
        self.con.executemany(
            "INSERT OR REPLACE INTO trajectories VALUES(?,?,json(?),json(?),json(?),json(?),json(?),json(?),json(?),json(?),json(?))",
            t_rows,
        )
        self.con.executemany(
            f"INSERT OR REPLACE INTO costs VALUES(?,?,?,{','.join('?' * len(self.cost_names))})",
            c_rows,
        )
        self.con.executemany(
            f"INSERT OR REPLACE INTO infeasability VALUES(?,?,?,{','.join('?' * len(INF_NAMES))})",
            i_rows,
        )
        self.con.executemany(
            f"INSERT OR REPLACE INTO sampling_params VALUES(?,?,{','.join('?' * 13)})",
            sp_rows,
        )
        self.con.commit()

        if self._traj_csv is not None:
            with open(self._traj_csv, "a") as fh:
                for i in range(m):
                    fh.write(";".join(
                        [str(time_step), str(i), f"{time_step}_{i}",
                         str(bool(feas[i])), "{:.3g}".format(float(mat[i, 1])),
                         "{:.3g}".format(dt),
                         _float_values(x[i]), _float_values(y[i]),
                         _float_values(th[i]), _float_values(kap[i]),
                         _float_values(th_cl[i]), _float_values(v[i]),
                         _float_values(a[i]), _float_values(s[i]),
                         _float_values(d[i]), "", "",
                         "{:.5g}".format(float(cost[i]))]
                        + ["{:.5g}".format(float(terms[i, order[n]]))
                           if n in order else "0" for n in self.cost_names]
                        + ["{:.5g}".format(float(slots[i, j]))
                           for j in (6, 8, 5, 7)]
                    ) + "\n")

    def close(self):
        self.con.close()
