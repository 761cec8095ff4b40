"""The post-passes of the port's device-resident run on a mesh of two ranks.

As `test_torch_mesh_paths.py`, for the responsibility term (the highway)
and the occlusion module with the visible-area stage (the blind spot), two
agents each, float64 at sampling level 1, cut to 9 steps (the risk stack
costs seconds per cycle on one CPU thread): every rank's sharded run equals
its solo run (statuses, steps and `found` equal, selections rtol 1e-12 /
atol 1e-15, trajectories within 1e-9).
"""
import pytest
import torch

from frenetix_tpu_torch.parallel.distributed import run_world
from tests import torch_mesh_worker as worker

torch.set_num_threads(1)

CASES = ["responsibility", "occlusion module"]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    onnx_dir = str(tmp_path_factory.mktemp("mesh_post"))
    return run_world(worker.device_paths, 2, args=(CASES, onnx_dir), timeout=400)


@pytest.mark.parametrize("case", CASES)
def test_sharded_post_pass_run_equals_its_solo_run(case, ranks):
    for rank, res in enumerate(ranks):
        solo, sharded, _ = res[case]
        worker.assert_sharded_equals_solo(sharded, solo, f"{case} rank {rank}")
        assert solo["found"].any(), case
