"""Simulation-level structured logging: simulation.db (SQLite).

The port's own copy of `frenetix_tpu/utils/sim_logging.py`, with the same
tables: `global_performance_measure`, `batch_performance_measure`, `meta`,
`results` and `scenario_evaluation` (the criticality metrics, written by
`frenetix_tpu_torch.evaluation`).  `log_evaluation` takes the port's
`evaluation.metrics.MetricTable` where the JAX package takes a DataFrame.
"""
from __future__ import annotations

import json
import os
import sqlite3
import time

__all__ = ["SimulationLogger", "require_strict_tables"]

# the first SQLite release with STRICT tables
STRICT_SQLITE = (3, 37, 0)


def require_strict_tables() -> None:
    """Raise where this SQLite cannot create the loggers' STRICT tables."""
    if sqlite3.sqlite_version_info < STRICT_SQLITE:
        raise RuntimeError(
            f"SQLite {sqlite3.sqlite_version} has no STRICT tables (needs "
            f"{'.'.join(map(str, STRICT_SQLITE))} or later); the simulation "
            "and trajectory logs cannot be written (run with --no-logging)")


class SimulationLogger:
    def __init__(self, log_dir: str, evaluation_metrics=None, log_time: bool = True):
        require_strict_tables()
        os.makedirs(log_dir, exist_ok=True)
        self.log_dir = log_dir
        self.log_time = log_time
        self.t0 = time.perf_counter()
        self.con = sqlite3.connect(os.path.join(log_dir, "simulation.db"))
        c = self.con
        if log_time:
            c.execute(
                """CREATE TABLE IF NOT EXISTS global_performance_measure(
                    scenario TEXT NOT NULL, time_step INT NOT NULL,
                    total_sim_time REAL NOT NULL, global_sim_preprocessing REAL,
                    global_batch_synchronization REAL, global_visualization REAL,
                    PRIMARY KEY(scenario, time_step)) STRICT"""
            )
            c.execute(
                """CREATE TABLE IF NOT EXISTS batch_performance_measure(
                    scenario TEXT NOT NULL, batch TEXT NOT NULL,
                    time_step INT NOT NULL, process_iteration_time REAL,
                    sim_step_time REAL NOT NULL, agent_planning_time REAL NOT NULL,
                    sync_time_in REAL, sync_time_out REAL,
                    PRIMARY KEY(scenario, batch, time_step)) STRICT"""
            )
        c.execute(
            """CREATE TABLE IF NOT EXISTS meta(
                scenario TEXT NOT NULL, num_agents INT NOT NULL, agent_ids ANY,
                original_planning_problem_id ANY, agent_batches ANY,
                duration_init REAL NOT NULL, sim_duration REAL, post_duration REAL,
                simulation_config ANY NOT NULL, planner_config TEXT NOT NULL,
                PRIMARY KEY(scenario)) STRICT"""
        )
        c.execute(
            """CREATE TABLE IF NOT EXISTS results(
                scenario TEXT NOT NULL, agent_id INT NOT NULL,
                original_planning_problem INTEGER NOT NULL,
                final_status INTEGER NOT NULL, last_timestep INTEGER NOT NULL,
                message TEXT, agent_success TEXT NOT NULL,
                PRIMARY KEY(scenario, agent_id)) STRICT"""
        )
        metrics = evaluation_metrics or []
        if metrics:
            cols = ", ".join(f"{m} ANY" for m in metrics)
            c.execute(
                f"""CREATE TABLE IF NOT EXISTS scenario_evaluation(
                    scenario TEXT NOT NULL, agent_id INT NOT NULL,
                    original_planning_problem INTEGER NOT NULL,
                    timestep INT NOT NULL, {cols},
                    PRIMARY KEY(scenario, agent_id, timestep)) STRICT"""
            )
            self.metrics = metrics
        else:
            self.metrics = []
        c.commit()

    def log_meta(self, scenario_id, agent_ids, original_pp_ids, duration_init,
                 sim_config, planner_config):
        self.con.execute(
            "INSERT OR REPLACE INTO meta VALUES(?,?,?,?,?,?,?,?,?,?)",
            (scenario_id, len(agent_ids), json.dumps(list(agent_ids)),
             json.dumps(list(original_pp_ids)), json.dumps([0]),
             duration_init, None, None,
             json.dumps(sim_config, default=str), json.dumps(planner_config, default=str)),
        )
        self.con.commit()

    def log_global_time(self, scenario_id, time_step, total, preproc=None,
                        sync=None, visu=None):
        if not self.log_time:
            return
        self.con.execute(
            "INSERT OR REPLACE INTO global_performance_measure VALUES(?,?,?,?,?,?)",
            (scenario_id, time_step, total, preproc, sync, visu),
        )

    def log_batch_time(self, scenario_id, batch, time_step, sim_step_time,
                       agent_planning_time, **kw):
        if not self.log_time:
            return
        self.con.execute(
            "INSERT OR REPLACE INTO batch_performance_measure VALUES(?,?,?,?,?,?,?,?)",
            (scenario_id, batch, time_step, kw.get("process_iteration_time"),
             sim_step_time, agent_planning_time, kw.get("sync_time_in"),
             kw.get("sync_time_out")),
        )

    def log_results(self, scenario_id, agents, original_pp_ids):
        rows = [
            (scenario_id, a.id, int(a.id in original_pp_ids), int(a.status),
             a.state.time_step, a.message,
             "success" if a.status.name == "COMPLETED_SUCCESS" else "failure")
            for a in agents
        ]
        self.con.executemany(
            "INSERT OR REPLACE INTO results VALUES(?,?,?,?,?,?,?)", rows
        )
        self.con.commit()

    def log_evaluation(self, scenario_id, agent_id, is_original, table):
        """table: a `MetricTable` (index = time steps, columns = metric
        names); NaN values are written as NULL."""
        cols = [m for m in self.metrics if m in table.columns]
        for ts, row in table.iterrows():
            self.con.execute(
                f"INSERT OR REPLACE INTO scenario_evaluation VALUES(?,?,?,?,{','.join('?' * len(self.metrics))})",
                (scenario_id, agent_id, int(is_original), int(ts))
                + tuple(float(row[m]) if m in cols and row[m] == row[m] else None
                        for m in self.metrics),
            )
        self.con.commit()

    def close(self):
        self.con.commit()
        self.con.close()
