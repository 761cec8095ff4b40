"""The `double_lane_change` family with the behavior planner (the goal two
lanes over): the port's `Simulation` against the JAX `Simulation` at float64
on the CPU, at its default size (188 steps), as the JAX package's
`tests/test_behavior.py::test_e2e_double_lane_change` runs it.

Equal steps and statuses, every executed position within 1e-6 m, and the
reference path rebuilt by the behavior module at the same steps (two lane
changes).  The JAX run is made once for the module.
"""
import numpy as np
import pytest
import torch

from torch_parity import paired_runs, statuses

torch.set_num_threads(1)

POS_TOL = 1e-6       # metres


@pytest.fixture(scope="module")
def runs():
    return paired_runs("double_lane_change", "float64", behavior=True)


def test_double_lane_change_matches_jax(runs):
    jax_run, port_run = runs
    assert port_run["result"].steps == jax_run["result"].steps == 188
    assert statuses(port_run["result"]) == statuses(jax_run["result"])
    assert port_run["swaps"] == jax_run["swaps"]
    for aid, want in jax_run["states"].items():
        got = port_run["states"][aid]
        assert got.shape == want.shape
        np.testing.assert_allclose(got[:, :2], want[:, :2], rtol=0, atol=POS_TOL)


def test_double_lane_change_changes_two_lanes(runs):
    """What the JAX package's end-to-end test asserts, on the port."""
    _, port_run = runs
    assert port_run["result"].success
    assert port_run["states"][60000][-1, 1] > 6.0, "the ego did not reach the third lane"
    assert len(port_run["swaps"]) >= 2
