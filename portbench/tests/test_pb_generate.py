"""The generator: the same seed gives the same requests, every request has
the cell's shapes and candidate counts, and each mix keeps its promises."""
from __future__ import annotations

import numpy as np
import pytest

from portbench import generate, reference
from portbench.tests.conftest import tiny

CELLS = ("ego_dense.sweep", "convoy8_risk.near", "convoy8_risk.open", "convoy8.plain")
LARGE_SEED = 2 ** 33 + 12_345


@pytest.mark.parametrize("workload", CELLS)
def test_same_seed_same_pool(workload):
    config, mix = tiny(workload)
    lines_a, pool_a = generate.draw_pool(config, mix, LARGE_SEED)
    lines_b, pool_b = generate.draw_pool(config, mix, LARGE_SEED)
    _, pool_c = generate.draw_pool(config, mix, LARGE_SEED + 1)
    assert np.array_equal(lines_a, lines_b)
    for a, b in zip(pool_a, pool_b):
        assert a.keys() == b.keys()
        assert all(np.array_equal(a[k], b[k]) for k in a)
    assert not all(np.array_equal(a["x0_lon"], c["x0_lon"]) for a, c in zip(pool_a, pool_c))


@pytest.mark.parametrize("workload", CELLS)
def test_every_request_has_the_cells_shapes(workload):
    config, mix = tiny(workload)
    _, pool = generate.draw_pool(config, mix, 7)
    shapes = {k: v.shape for k, v in pool[0].items()}
    for req in pool:
        assert {k: v.shape for k, v in req.items()} == shapes
        for a in range(config["agents"]):
            matrix, mask = reference.sampling(config, req, a)
            assert mask.sum() == config["candidates_per_agent"]
            assert req["x0_lon"][a, 1] >= config["planning"]["low_vel_mode_threshold"]


def test_full_size_counts():
    """At the cells' own sizes: 34,320 and 800 candidates per agent."""
    from portbench import spec

    for name, mix in (("ego_dense", "sweep"), ("convoy8_risk", "near")):
        config, traffic = spec.config(name), spec.traffic(mix)
        traffic["pool_requests"] = 2
        _, pool = generate.draw_pool(config, traffic, 11)
        for req in pool:
            for a in range(config["agents"]):
                _, mask = reference.sampling(config, req, a)
                assert mask.sum() == config["candidates_per_agent"]
                assert mask.shape[0] % config["sampling"]["bucket"] == 0


def test_near_and_open_obstacles():
    """near: 2-7 valid slots per agent, one 8-20 m ahead; open: at most one,
    25 m or more from the agent and never closer than it started."""
    config, mix = tiny("convoy8_risk.near")
    _, pool = generate.draw_pool(config, mix, 5)
    for req in pool:
        counts = req["valid"][:, :, 0].sum(axis=1)
        assert counts.min() >= 2 and counts.max() <= 7
    config, mix = tiny("convoy8_risk.open")
    mix["pool_requests"] = 8
    _, pool = generate.draw_pool(config, mix, 5)
    lines = generate.centerlines(config)
    seen = 0
    for req in pool:
        assert req["valid"][:, :, 0].sum(axis=1).max() <= 1
        for a, o in zip(*np.nonzero(req["valid"][:, :, 0])):
            tab = reference.road.reference_path(lines[a], extension=config["road"]["extension_m"])
            s0 = req["x0_lon"][a, 0]
            ego = np.array([np.interp(s0, tab.s, tab.xy[:, 0]),
                            np.interp(s0, tab.s, tab.xy[:, 1])])
            assert np.linalg.norm(req["means"][a, o, 0] - ego) >= 20.0
            seen += 1
    assert seen > 0
