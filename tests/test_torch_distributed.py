"""The port's process-level layer: `parallel.distributed`,
`parallel.scenario_sharding` and the CLI's `--workers` pipeline.

- `shard_scenarios` of both modules equal to the JAX package's for several
  (rank, world);
- `merge_score_csvs` writes the bytes the JAX package writes from the same
  CSVs;
- `initialize()` without a coordinator is a no-op, and `process_info()` /
  `host_info()` are then (0, 1); from torchrun's environment variables it
  joins a world (one rank over localhost, in a subprocess);
- `process_info()` and `host_info()` in a 2-rank gloo world (spawned
  processes, rank functions in `tests/torch_mesh_worker.py`);
- `run_sharded_pipeline` in a world of one rank on two scenario families:
  the rows of the port's sequential CLI run;
- `--workers 2` against the sequential CLI run on two families and a missing
  file: the same score rows up to `wall_s`, the same printed statuses, the
  same failure row, exit code 1 for both.

Scenarios run in float32 at sampling level 1 on the CPU.
"""
import csv

import pytest
import torch

from frenetix_tpu_torch.parallel import distributed as tdist
from frenetix_tpu_torch.parallel import scenario_sharding as tshard
from frenetix_tpu_torch.run_scenario import main
from tests import torch_mesh_worker as worker

torch.set_num_threads(1)

FAMILIES = ["curve", "highway"]       # sorted: the pipeline sorts its targets
COARSE = ["--set", "planning.sampling_min=1", "--set", "planning.sampling_max=2"]


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.reader(f, delimiter=";"))


@pytest.mark.parametrize("rank,world", [(0, 1), (0, 3), (1, 3), (2, 3), (3, 4),
                                        (5, 8)])
def test_shard_scenarios_match_jax(rank, world):
    from frenetix_tpu.parallel import distributed as jdist
    from frenetix_tpu.parallel import scenario_sharding as jshard

    paths = [f"s/{c}{i}.xml" for i, c in enumerate("qwertyuiopasdfg")]
    want = jdist.shard_scenarios(paths, rank, world)
    assert tdist.shard_scenarios(paths, rank, world) == want
    assert jshard.shard_scenarios(paths, rank, world) == want
    assert tshard.shard_scenarios(paths, rank, world) == want


def test_merge_score_csvs_matches_jax(tmp_path):
    from frenetix_tpu.parallel.distributed import merge_score_csvs as jmerge

    dirs = []
    for i, rows in enumerate([[["a", "1", "10", "COMPLETED_SUCCESS", "success", "0.5"]],
                              [], [["b", "2", "7", "COLLISION", "collision", "1.25"],
                                   ["c", "3", "9", "TIMELIMIT", "x;y", "2.0"]]]):
        d = tmp_path / f"host{i}"
        d.mkdir()
        dirs.append(str(d))
        if i == 1:
            continue            # a host without a score file
        with open(d / "score_overview.csv", "w", newline="") as f:
            w = csv.writer(f, delimiter=";")
            w.writerow(["scenario", "agent", "timestep", "status", "message", "wall_s"])
            w.writerows(rows)
    want = jmerge(dirs, str(tmp_path / "jax.csv"))
    got = tdist.merge_score_csvs(dirs, str(tmp_path / "port.csv"))
    assert want and got
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()
    assert tdist.merge_score_csvs([str(tmp_path / "host1")], str(tmp_path / "x")) is None


def test_initialize_without_a_coordinator_is_a_no_op(monkeypatch):
    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(name, raising=False)
    assert tdist.initialize() is False
    assert tdist.process_info() == (0, 1)
    assert tshard.host_info() == (0, 1)


def test_initialize_reads_the_torchrun_environment():
    """MASTER_ADDR / MASTER_PORT / WORLD_SIZE / RANK / LOCAL_RANK, as torchrun
    sets them: a world of one rank on localhost (port 0: the store takes a
    free one), gloo for the CPU."""
    import os
    import subprocess
    import sys

    code = ("import torch.distributed as dist\n"
            "from frenetix_tpu_torch.parallel.distributed import initialize, process_info\n"
            "print(initialize(device='cpu'), process_info(), dist.get_backend())\n"
            "dist.destroy_process_group()\n")
    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT="0", WORLD_SIZE="1",
               RANK="0", LOCAL_RANK="0",
               PYTHONPATH=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split("\n")[0] == "True (0, 1) gloo"


def test_process_info_in_a_two_rank_world():
    assert tdist.run_world(worker.process_info_rank, 2, timeout=120) == [
        ((0, 2), (0, 2)), ((1, 2), (1, 2))]


@pytest.fixture(scope="module")
def sequential_cli(tmp_path_factory):
    logs = tmp_path_factory.mktemp("sequential")
    rc = main([*FAMILIES, "no_such_scenario.xml", "--device", "cpu", "--logs",
               str(logs), "--no-logging", *COARSE])
    return rc, logs


def test_sharded_pipeline_equals_the_sequential_run(sequential_cli, tmp_path):
    _, logs = sequential_cli
    (results,) = tdist.run_world(worker.sharded_pipeline, 1,
                                 args=(FAMILIES, str(tmp_path)), timeout=240)
    got = _rows(tmp_path / "score_overview_host0.csv")
    want = _rows(logs / "score_overview.csv")
    assert got[0] == want[0]
    assert [r[0] for r in got[1:]] == FAMILIES
    # the CLI names a scenario by its id, the pipeline by its target
    assert [r[1:5] for r in got[1:]] == [r[1:5] for r in want[1:]]
    assert results == [(r[1], r[3]) for r in want[1:]]


def test_workers_equal_the_sequential_run(sequential_cli, tmp_path, capsys):
    rc_seq, logs = sequential_cli
    capsys.readouterr()
    rc = main([*FAMILIES, "no_such_scenario.xml", "--device", "cpu", "--logs",
               str(tmp_path), "--no-logging", "--workers", "2", *COARSE])
    printed = [line.split(" wall_s=")[0] for line in capsys.readouterr().out.splitlines()
               if " agent=" in line]
    assert rc == rc_seq == 1          # the missing file fails both
    got, want = _rows(tmp_path / "score_overview.csv"), _rows(logs / "score_overview.csv")
    assert len(got) == len(want) == 1 + len(FAMILIES)
    assert [r[:5] for r in got] == [r[:5] for r in want]
    assert all(r[3] == "COMPLETED_SUCCESS" for r in got[1:])
    assert printed == [f"{r[0]} agent={r[1]} status={r[3]} steps={r[2]}" for r in want[1:]]
    fail_got = _rows(tmp_path / "log_failures.csv")
    fail_want = _rows(logs / "log_failures.csv")
    assert [r[:2] for r in fail_got] == [r[:2] for r in fail_want]
    assert fail_got[0][0] == "no_such_scenario"
