"""The `double_crossing` family with the behavior planner (traffic crosses
the far of two junctions only): the port's `Simulation` against the JAX
`Simulation` at float64 on the CPU, at its default size (159 steps), as the
JAX package's `tests/test_behavior.py::test_e2e_double_crossing` runs it.

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
    return paired_runs("double_crossing", "float64", behavior=True)


def test_double_crossing_matches_jax(runs):
    jax_run, port_run = runs
    assert port_run["result"].steps == jax_run["result"].steps == 159
    assert statuses(port_run["result"]) == statuses(jax_run["result"])
    assert port_run["swaps"] == jax_run["swaps"]
    for aid, want in jax_run["states"].items():
        got = port_run["states"][aid]
        assert got.shape == want.shape
        np.testing.assert_allclose(got[:, :2], want[:, :2], rtol=0, atol=POS_TOL)


def test_double_crossing_drives_through_without_yielding(runs):
    """What the JAX package's end-to-end test asserts, on the port."""
    _, port_run = runs
    assert port_run["result"].success
    xs, vs = port_run["states"][60000][:, 0], port_run["states"][60000][:, 2]
    assert xs[80] > 10.0, "the ego waited at the near junction"
    assert vs.min() > 2.0 and xs[-1] > 90.0
