"""Simulation evaluation: metrics → MetricTable → simulation.db.

The port's own copy of `frenetix_tpu/evaluation/evaluate.py`: computes the
criticality metrics of every agent of a finished simulation and writes them
to the `scenario_evaluation` table, runs the vehicle-dynamics solution check
per agent, and writes a CommonRoad solution XML with its WX1 cost per
successful agent.
"""
from __future__ import annotations

import os

import numpy as np

from frenetix_tpu_torch.evaluation.metrics import Measures, enabled_metrics
from frenetix_tpu_torch.evaluation.solution_check import check_solution
from frenetix_tpu_torch.evaluation.solution_cost import benchmark_cost
from frenetix_tpu_torch.io.solution_writer import write_solution
from frenetix_tpu_torch.sim.agent import AgentStatus

__all__ = ["evaluate_simulation"]


def evaluate_simulation(scenario, result, config=None, sim_logger=None,
                        metrics=None, msg_logger=None, check_solutions=True,
                        log_dir=None):
    """→ {agent_id: MetricTable}; logs to sim_logger when provided.  Also
    runs the vehicle-dynamics solution check per agent, and with `log_dir`
    set writes a CommonRoad competition solution XML per successful agent
    plus its WX1 benchmark cost.

    `config.evaluation` (evaluation.yaml) controls the per-metric enable map
    (criticality_metrics), the participant radius, the TET/TIT threshold tau
    and a_max_lat; explicit `metrics`/`check_solutions` arguments override."""
    ev = config.evaluation if config is not None else None
    if metrics is None:
        metrics = enabled_metrics(ev.criticality_metrics if ev else {})
    veh = config.vehicle if config is not None else None
    dt = scenario.dt
    out = {}
    original_ids = set(scenario.planning_problems.keys())
    for aid, states in result.histories.items():
        m = Measures(
            aid, scenario, states, other_histories=result.histories, dt=dt,
            a_max_long=veh.a_max if veh else 11.5,
            a_max_lat=ev.a_max_lat if ev else 8.0,
            radius=ev.radius if ev else 100.0,
            tau=ev.tau if ev else 2.0,
            veh_length=veh.length if veh else 4.508,
            veh_width=veh.width if veh else 1.61,
        )
        table = m.compute(metrics)
        out[aid] = table
        if msg_logger and {"ttc", "jerk", "tet"} <= set(table.columns):
            ttc = table["ttc"]
            finite_ttc = ttc[np.isfinite(ttc)]
            msg_logger.info(
                f"agent {aid}: min TTC "
                f"{finite_ttc.min() if len(finite_ttc) else float('inf'):.2f}s, "
                f"max |jerk| {np.nanmax(np.abs(table['jerk'])):.2f}, TET "
                f"{np.nansum(table['tet']):.2f}s"
            )
        if sim_logger is not None:
            sim_logger.log_evaluation(
                result.scenario_id, aid, aid in original_ids, table
            )
        if check_solutions and veh is not None and msg_logger:
            chk = check_solution(states, veh, dt)
            msg_logger.info(
                f"agent {aid} solution check: feasible={chk.feasible} "
                f"pos_err={chk.max_position_error:.3f}m "
                f"orient_err={chk.max_orientation_error:.3f}rad "
                f"input_violations={chk.input_violations}"
            )
        if (log_dir is not None and check_solutions
                and result.agent_status.get(aid)
                == AgentStatus.COMPLETED_SUCCESS):
            path = os.path.join(log_dir, f"solution_{aid}.xml")
            cost = benchmark_cost(states, dt)
            # the XML stamps which weight set produced the logged cost: the
            # COST_COMBINATIONS are estimated transcriptions, so the value
            # is labeled approximate
            write_solution(path, result.scenario_id, {aid: states}, dt,
                           cost_weights=cost["weights"])
            if msg_logger:
                msg_logger.info(
                    f"agent {aid} solution written: {path} "
                    f"WX1 cost {cost['total']:.2f} (approximate — "
                    f"estimated weight transcription)")
    return out
