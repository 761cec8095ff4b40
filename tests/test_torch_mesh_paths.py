"""The behavior and Wale-Net paths of the port's device-resident run on a
mesh of two ranks.

`DeviceSimulation(sim, mesh=...)` splits every program of a cycle over the
ranks and all-gathers the selection inside the body, on every path the run
has.  Here, in a 2-rank gloo world (rank functions in
`tests/torch_mesh_worker.py`), float64 at sampling level 1, two agents
each, every rank holds its sharded run against its solo run of the same
scenario to the JAX device test's tolerances (statuses, steps and `found`
equal, selections rtol 1e-12 / atol 1e-15, trajectories within 1e-9):

- the behavior FSM in the run and forced onto the hybrid path (the convoy
  with one lead vehicle);
- Wale-Net's hybrid prediction path (the highway, a narrow synthetic export).

The post-passes on a mesh are `test_torch_mesh_post.py`'s, the overtake's
run and the fleet on a mesh `test_torch_mesh_sim.py`'s.
"""
import pytest
import torch

from frenetix_tpu_torch.parallel.distributed import run_world
from tests import torch_mesh_worker as worker

torch.set_num_threads(1)

CASES = ["in-run FSM", "hybrid behavior", "hybrid walenet"]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    onnx_dir = str(tmp_path_factory.mktemp("mesh_paths"))
    return run_world(worker.device_paths, 2, args=(CASES, onnx_dir), timeout=400)


@pytest.mark.parametrize("case", CASES)
def test_sharded_device_path_equals_its_solo_run(case, ranks):
    for rank, res in enumerate(ranks):
        solo, sharded, fsm_in_scan = res[case]
        worker.assert_sharded_equals_solo(sharded, solo, f"{case} rank {rank}")
        what = f"{case} rank {rank}"
        if case == "in-run FSM":
            assert fsm_in_scan, what
        if case == "hybrid behavior":
            assert not fsm_in_scan, what
