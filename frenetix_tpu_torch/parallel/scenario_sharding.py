"""Scenario sharding over processes (the evaluation pipeline's scale-out axis).

PyTorch port of `frenetix_tpu/parallel/scenario_sharding.py`.  Each process
of a torch.distributed world (one per card, or one per host) plans its share
of the scenario set on its own, with no communication inside a run; the
per-process score files merge afterwards (`distributed.merge_score_csvs`,
or `cat`).  Without a world a process is rank 0 of 1 and runs everything.
"""
from __future__ import annotations

import csv
import os

import torch.distributed as dist

__all__ = ["host_info", "shard_scenarios", "run_sharded_pipeline"]


def host_info():
    """(rank, world size): the torch.distributed world's, or (0, 1)."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def shard_scenarios(paths, process_index=None, process_count=None):
    """Deterministic round-robin shard of the scenario list for this process."""
    if process_index is None or process_count is None:
        process_index, process_count = host_info()
    return [p for i, p in enumerate(sorted(paths)) if i % process_count == process_index]


def run_sharded_pipeline(scenario_paths, config, logs_dir, *, evaluate=False,
                         msg_logger=None, device=None):
    """Run this process's shard of the scenario set (XML paths or family
    names, through `run_scenario.run_one` on `device`, the CUDA device by
    default); returns the per-scenario results.

    Score rows land in `<logs_dir>/score_overview_host<rank>.csv`, so that
    processes never contend on one file."""
    from frenetix_tpu_torch.run_scenario import run_one

    idx, count = host_info()
    mine = shard_scenarios(scenario_paths, idx, count)
    out = []
    score_path = os.path.join(logs_dir, f"score_overview_host{idx}.csv")
    os.makedirs(logs_dir, exist_ok=True)
    with open(score_path, "w", newline="") as f:
        w = csv.writer(f, delimiter=";")
        w.writerow(["scenario", "agent", "timestep", "status", "message", "wall_s"])
        for path in mine:
            name = os.path.splitext(os.path.basename(path))[0]
            res = run_one(path, config, msg_logger, log_dir=os.path.join(logs_dir, name),
                          evaluate=evaluate, device=device)
            out.append(res)
            for aid, st in res.agent_status.items():
                w.writerow([name, aid, res.steps, st.name,
                            res.agent_messages[aid], round(res.wall_time, 2)])
    return out
