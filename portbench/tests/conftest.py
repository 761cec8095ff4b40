"""Small versions of the cells, for the CPU: the same road, traffic and
code paths, fewer candidates, agents and slots."""
from __future__ import annotations

import copy

import pytest
import torch

from portbench import spec


def tiny(workload: str):
    """(config, mix) of a cell cut to a size the CPU runs in seconds."""
    cell = spec.cell(spec.load(), workload)
    config = copy.deepcopy(spec.config(cell["config"]))
    mix = copy.deepcopy(spec.traffic(cell["traffic"]))
    config["sampling"]["lateral"]["level"] = 1
    config.update(warmup_requests=1, check_requests=2, trace_after_requests=0,
                  trace_requests=2)
    if config["agents"] == 1:
        config["sampling"]["velocity"]["level"] = 1
        config["sampling"]["bucket"] = 256
        config["candidates_per_agent"] = 8 * 5 * 6
        mix["pool_requests"] = 3
    else:
        config.update(agents=2, obstacle_slots=8, candidates_per_agent=8 * 10 * 6,
                      check_requests=1)
        mix["pool_requests"] = 2
    return config, mix


@pytest.fixture
def cpu():
    torch.set_num_threads(4)
    return torch.device("cpu")
