"""The port's float32 against the JAX package's float32 on the CPU: the
highway with two agents, batched (`start_multiagent`,
`batched_device_agents`), at its default size.

Both packages round differently in float32, so the runs differ by a few
float32 ulps from the first steps; they must take the same steps (215) with
the same statuses, and every agent's executed positions must stay within
`POS_TOL` of JAX's over the whole run (measured on the CPU: 4.6e-5 m).
The JAX float32 run is made once for the module.
"""
import numpy as np
import pytest
import torch

from torch_parity import paired_runs, statuses

torch.set_num_threads(1)

POS_TOL = 1e-3       # metres


@pytest.fixture(scope="module")
def runs():
    return paired_runs("highway", "float32", multiagent=True)


def test_highway_two_agents_float32_steps_and_statuses_match_jax(runs):
    jax_run, port_run = runs
    assert len(port_run["states"]) == 2
    assert port_run["result"].steps == jax_run["result"].steps
    assert statuses(port_run["result"]) == statuses(jax_run["result"])
    assert port_run["result"].success


def test_highway_two_agents_float32_positions_match_jax(runs):
    jax_run, port_run = runs
    for aid, want in jax_run["states"].items():
        got = port_run["states"][aid]
        assert got.shape == want.shape, aid
        np.testing.assert_allclose(got[:, :2], want[:, :2], rtol=0, atol=POS_TOL,
                                   err_msg=str(aid))
        np.testing.assert_allclose(got[-1, :2], want[-1, :2], rtol=0, atol=POS_TOL)
