"""The sharded simulations of the port in gloo worlds, port against port.

The port's batched host run, device-resident run and fleet are held against
the JAX package elsewhere (`test_torch_multiagent.py`,
`test_torch_device_sim.py`, `test_torch_fleet.py`); here the same runs split
over the ranks of a torch.distributed world (2 spawned CPU processes, rank
functions in `tests/torch_mesh_worker.py`) are held against them, float64,
level-1 sampling:

- the highway with `start_multiagent`, `batched_device_agents` and
  `sharded_device_agents` on every rank: statuses and steps equal to the
  batched run, positions within 1e-9 m; only rank 0 keeps its log directory;
- `DeviceSimulation(make_overtake(), mesh=2 ranks)` against the solo run, to
  the JAX test's tolerances (`tests/test_device_sim.py`): statuses and steps
  equal, selections rtol 1e-12 / atol 1e-15, trajectories within 1e-9;
- `run_fleet(mesh=2 ranks)` on two highways against the unsharded fleet; a
  fleet of three over two ranks raises ValueError;
- a mesh of three ranks for two agents raises ValueError (a world of 3);
- `graft_entry.dryrun_multichip(2)` passes.
"""
import numpy as np
import pytest
import torch

from frenetix_tpu_torch.io.scenario_factory import make_highway, make_overtake
from frenetix_tpu_torch.parallel.device_sim import DeviceSimulation, run_fleet
from frenetix_tpu_torch.parallel.distributed import run_world
from frenetix_tpu_torch.sim.simulation import Simulation
from tests import torch_mesh_worker as worker
from tests.torch_parity import CPU

torch.set_num_threads(1)

WORLD = 2


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    log_dir = str(tmp_path_factory.mktemp("mesh_sim_logs"))
    return run_world(worker.sim_cases, WORLD, args=(log_dir,), timeout=300)


def _assert_device_equal(got, want, what):
    assert got["steps"] == want["steps"], what
    np.testing.assert_array_equal(got["status"], want["status"], err_msg=what)
    np.testing.assert_array_equal(got["found"], want["found"], err_msg=what)
    np.testing.assert_allclose(got["selections"], want["selections"], rtol=1e-12,
                               atol=1e-15, err_msg=what)
    np.testing.assert_allclose(got["trajectories"], want["trajectories"], atol=1e-9,
                               err_msg=what)


def test_sharded_host_run_equals_the_batched_run(ranks):
    batched = worker.host_result(Simulation(
        make_highway(n_steps=worker.HIGHWAY_STEPS), worker.sim_config(batched=True),
        CPU).run())
    assert len(batched["status"]) == 2
    for rank, res in enumerate(ranks):
        got = res["highway"]
        assert res["mesh_size"] == WORLD
        assert got["status"] == batched["status"] and got["steps"] == batched["steps"]
        for aid, pos in batched["positions"].items():
            np.testing.assert_allclose(got["positions"][aid], pos, atol=1e-9,
                                       err_msg=f"rank {rank} agent {aid}")


def test_only_rank_zero_keeps_its_logs(ranks):
    assert [res["writes_logs"] for res in ranks] == [True] + [False] * (WORLD - 1)


def test_sharded_device_run_equals_the_solo_run(ranks):
    solo = worker.device_result(DeviceSimulation(Simulation(
        make_overtake(n_steps=worker.OVERTAKE_STEPS), worker.sim_config(), CPU)).run())
    assert len(solo["status"]) == WORLD and (solo["status"] == 2).all()
    for rank, res in enumerate(ranks):
        _assert_device_equal(res["overtake"], solo, f"rank {rank}")


def test_sharded_fleet_equals_the_unsharded_fleet(ranks):
    plain = [worker.device_result(d) for d in run_fleet(worker.fleet_members(2))]
    for rank, res in enumerate(ranks):
        assert len(res["fleet"]) == len(plain)
        for i, (got, want) in enumerate(zip(res["fleet"], plain)):
            _assert_device_equal(got, want, f"rank {rank} member {i}")


def test_sharded_runs_carry_the_solo_margins(ranks):
    """With `emit_margins` the agent mesh gathers every agent's margins with
    its selection, and the fleet mesh gathers every member's."""
    solo = [worker.device_result(DeviceSimulation(Simulation(
        make_overtake(n_steps=worker.OVERTAKE_STEPS), worker.sim_config(), CPU)).run(
            emit_margins=True))]
    plain = [worker.device_result(d) for d in run_fleet(worker.fleet_members(2),
                                                         emit_margins=True)]
    for rank, res in enumerate(ranks):
        for got, want in zip([res["overtake_margins"]] + res["fleet_margins"], solo + plain):
            _assert_device_equal(got, want, f"rank {rank}")
            for g, w in zip(got["margins"], want["margins"]):
                assert g is not None and g.shape == want["found"].shape
                np.testing.assert_array_equal(np.isfinite(g), np.isfinite(w))
                ok = np.isfinite(w)
                np.testing.assert_allclose(g[ok], w[ok], rtol=0, atol=1e-9)


def test_fleet_not_dividing_the_mesh_raises(ranks):
    for res in ranks:
        assert "must divide evenly" in res["fleet_of_three"]


def test_mesh_larger_than_the_agent_count_raises():
    messages = run_world(worker.mesh_of_three, 3, timeout=180)
    assert all(m is not None and "must divide evenly" in m for m in messages), messages


def test_dryrun_multichip_on_two_ranks(capsys):
    from frenetix_tpu_torch.graft_entry import dryrun_multichip

    results = dryrun_multichip(2, "cpu", config=worker.sim_config(multi=False),
                               n_steps=worker.OVERTAKE_STEPS, timeout=300)
    assert "dryrun_multichip OK: 2 ranks" in capsys.readouterr().out
    assert [r["sharded_steps"] is not None for r in results] == [True, True]
