"""The `s_curve` family (a left bend into a right bend), without the
behavior planner: the port's `Simulation` against the JAX `Simulation` at
float64 on the CPU, at its default size (238 steps).

Equal steps and statuses, every executed position within 1e-6 m.  The JAX
run is made once for the module.
"""
import numpy as np
import pytest
import torch

from torch_parity import paired_runs, statuses

torch.set_num_threads(1)

POS_TOL = 1e-6       # metres


@pytest.fixture(scope="module")
def runs():
    return paired_runs("s_curve", "float64")


def test_s_curve_matches_jax(runs):
    jax_run, port_run = runs
    assert port_run["result"].steps == jax_run["result"].steps == 238
    assert statuses(port_run["result"]) == statuses(jax_run["result"])
    for aid, want in jax_run["states"].items():
        got = port_run["states"][aid]
        assert got.shape == want.shape
        np.testing.assert_allclose(got[:, :2], want[:, :2], rtol=0, atol=POS_TOL)


def test_s_curve_reaches_its_goal_through_both_bends(runs):
    _, port_run = runs
    assert port_run["result"].success
    xy = port_run["states"][60000][:, :2]
    heading = np.unwrap(np.arctan2(np.diff(xy[:, 1]), np.diff(xy[:, 0])))
    assert heading.max() > 0.3 and heading[-1] < heading.max() - 0.3, \
        "the ego did not turn left and then right"
